#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (flowmirror_hydravox_tpu_torch).

    python3 chip_smoke.py
    python3 chip_smoke.py --ab-parent DIR

Needs one CUDA GPU and a checkout of the repository around this file; it
exits non-zero without either. With --ab-parent it runs none of the phases
below: DIR is an earlier commit's port unpacked into a gitignored directory
(`git archive <commit> flowmirror_hydravox_tpu_torch | tar -x -C DIR`), and
kernel 2's int8 form of that tree is timed in turns with this tree's
(earlier, this, this, earlier) at every bf16 shape that phase 5i served in
a run before (that run's chiprun_out/chip_smoke.json) and at AB_SHAPES;
it writes chiprun_out/ab_mlp_int8.json. Phases, each fatal on failure:

  1. census: the card's name and power limit (nvidia-smi);
  2. build: nvcc builds every kernel of the main path from the checkout, one
     process per source, all started together; each one's ptxas lines;
  3. decode attention against its plain version at the main path's shapes,
     the zero-shot prefills of a 3 s and a 10 s prompt (T and S_max as the
     engine pads them), the flash batches of zero-shot rows that phase 5f
     serves (B 2, 3 and 4: 3 s and 10 s zero-shot rows, cross-lingual and
     SFT rows padded to the longest; each batch's prefill and its first
     decode step with every row's own cache_len), the spec verify blocks
     (T = K = 5 at B 1 / S_max 512 and at B 4 / S_max 768 with diverging
     cache_len), and at the edges of its design (split boundaries,
     row tiles, a row with cache_len 0), each twice (the two calls must be bit-equal), with times
     (CUDA events, L2 flushed before each launch), the plain version's and
     one library call's (SDPA with the same additive mask, a yardstick
     only), and the byte/operation bound; before it, the launch floor: a
     one-element zero_() timed the same way;
  3b. the fused SwiGLU-MLP GEMV against its plain version at the decode
     MLP's shapes (backbone 896 x 4864 at M = B x K rows, MTP heads
     896 x 22016 at M = B; the spec verify blocks at M 5, 20 and 40 of
     both widths, head 0 on the block at the MTP width) and at edges (M 9,
     16, 65; a ragged I), bf16 and
     f32, twice each (bit-equal), timed the same way; its yardstick
     is the torch.matmul form (three cuBLAS products and two elementwise
     ops: no single PyTorch call computes this function);
  4. the full-width backbone on the card (both kernels) against the CPU
     (plain versions), f32: a prefill and decode blocks at B 1, and a
     batched decode block at B 3, K 2 with per-row lengths;
  5. the main path: the default HydraVoxConfig() with random weights (LLM and
     flow bf16, HiFT f32) behind the port's HTTP server on 127.0.0.1:
     POST /api/v1/tts at inference_head_num 1 and 5 (one sentence each,
     `Engine.synthesize`), a two- and a four-segment text at heads 2 (one
     `Engine.synthesize_batch` each, a row per segment), and a burst of
     three concurrent one-sentence requests against a server with a 0.25 s
     window, served as one coalesced flash batch. Each WAV must be 24 kHz,
     non-empty and finite; for every request each kernel's launch count
     must equal the count the code predicts (decode attention: n_layers x
     backbone forwards; MLP GEMV: n_layers x decode-step forwards + heads x
     steps);
  5b. continuous batching: six one-sentence requests sent 0.15 s apart to a
     window-mode server (the default 0.03 s window), then the same six to a
     server with 4 continuous slots at heads 2 (the launcher's default
     mode), followed there by a four-segment text (four slot requests) and,
     on its own, a request at top_p 0.5 and heads 1, which the worker must
     serve. Each WAV is checked as in phase 5; /api/v1/metrics must count 7
     more continuous requests and report admission_ms_p50; some request
     must take a slot while another slot is decoding (the requests' own
     admit and decode-done times); the slots' launches must equal the
     prediction from the batcher's stats (attention: n_layers x (admits +
     forwards); MLP: n_layers x forwards + heads x steps), the window
     load's and the worker request's as in phase 5. Both modes' p50/p95
     latency, tokens/s over the load and ms per decode step are printed:
     a smoke check of both modes on one seeded burst, not a comparison
     (tools/serve_load.py compares them under a sustained load);
  5c. streaming, POST /api/v1/tts/stream, every stream seeded: against a
     window-mode server (every stream on the stream lane) a one-sentence
     stream twice on one seed (the PCM must be identical) and a two-segment
     stream; against a server with 4 slots, one reserved for streams (the
     launcher's default), three concurrent /api/v1/tts requests and then the
     one-sentence stream on the same seed, which must take the reserved slot
     within one chunk plus the syntheses queued ahead of it; two concurrent
     streams on the slots; a stream at top_p 0.5, which must take the stream
     lane. Each stream's header must be the JAX server's bytes (24 kHz), its
     PCM non-empty, a one-segment stream's length a multiple of
     token_mel_ratio x upsampling (960); continuous_requests must count the
     slot streams; launches must equal the prediction (the lane's from each
     session's steps, the slots' from the batcher's stats). Printed per
     stream, not gated: time to first audio and the gaps between chunks,
     timed at the service's chunk queue; each chunk's synthesis seconds
     against its audio seconds; underruns (a chunk arriving after the audio
     before it has finished playing); whether the slot stream's tokens equal
     the lane stream's on the same seed (bf16 may round a one-row burst and
     a four-row step apart);
  5d. zero-shot, voice conversion and the speaker registry, every request
     seeded, at heads 2: first the frontend on the card against the same
     frontend on the CPU for a seeded voiced prompt at 16 kHz (3 s) and at
     24 kHz (10 s): speech tokens exact, or each flip printed with its
     distance to a half-integer (none farther than 1e-3), the prompt mel
     within 1e-3 and the embedding within 1e-4, and the tokens again with
     cuDNN's TF32 on, as the launcher leaves it (the differences counted).
     Then, against a window-mode server: /api/v1/speakers/add with the 3 s
     prompt and its transcript; /api/v1/zero-shot in each mode
     (zero_shot, cross_lingual, instruct2), with the 10 s prompt, and a
     two-segment text; /api/v1/tts on the added speaker and, with
     last_prompt, a three-segment text; /api/v1/vc; against a server with 4
     slots, a zero-shot request (which the worker must serve) and
     /api/v1/tts on the added speaker (a slot). Each WAV as in phase 5; each
     request's launches equal the prediction (the worker's from its engine
     calls, the slots' from the batcher's stats), voice conversion's zero;
     the 3 s and 10 s zero-shot prefills, as the engine built them (the
     prompt block's rows and the KV cache it allocated), must have the
     (T, S_max) that phase 3 timed.
     Then the registry is saved, the speaker removed (/api/v1/tts on it must
     give 500 naming the speakers), a zero-shot request without prompt
     audio must give 400, and the launcher with --spk2info on the saved
     file must list exactly the saved speaker. Printed per request: prompt
     seconds, prefill (T, S_max), frontend seconds, tokens, RTF;
  5e. the reference's .pt weights at full width: seeded llm.pt, flow.pt and
     hift.pt in the reference key layout (bf16 tensors, HiFT's convs as
     weight-norm pairs) in a temporary directory, served through the
     launcher's build(--model-dir): the served trees must be the
     converter's at the serving dtypes and the text vocab the
     checkpoint's; one /api/v1/tts request (launches held); then, on a
     server with 4 slots, /api/v1/load_pt swaps in a second seed's llm.pt
     while 3 senders keep the slots busy: a request must be in a slot at
     the swap, every request must finish, the live tree must be the new
     checkpoint's, and the same seeded request must decode other tokens
     after it (the slots' launches held from the batcher's stats). That
     second checkpoint's decoder scores no stop id, so its decodes run to
     max_len: phase 5g's fallback request runs on it here;
  5f. zero-shot on the batched routes: a zero-shot request with the 3 s
     prompt, one with the 10 s prompt and an SFT request at the zero-shot
     sampling, sent together to a server with a 0.25 s window, must be one
     flash batch of 3 rows (batched_requests +3) whose prefill has the
     (T, S_max) of phase 3's B 3 case, read from the prompt block and KV
     cache the engine built; each request then alone on its seed, and
     whether its tokens equal its row's printed (a seeded row draws what it
     would alone, `noise.RowNoise`, but a B-row bf16 product need not
     round as a one-row one: not gated). Then, on a server with 4 slots,
     two plain zero-shot requests at the slots' sampling (continuous_requests
     +2) and a cross-lingual one (the worker). Launches held throughout;
  5g. the solo route's output rule: single-segment speed-1 requests, seeds
     tried in turn, until one's tokens fit the estimated stage-2 bucket
     (the main weights) and one outgrows it (the short text on phase 5e's
     never-stopping weights, the realised bucket); each rule and bucket
     printed, launches held;
  5h. self-speculative MTP decoding (--spec-decode): first, f32 greedy
     decoding (top_k 1, tau_r 2) of 100 tokens, llm.generate at heads 1
     against llm.generate_speculative at heads 2 and 5 on other draws: the
     tokens must be equal, or differ first where heads 1's two top logits
     lie within 1e-4 (the margin printed); then, bf16, every route through
     servers on an engine with the launcher's --spec-decode, beside the same
     seeded requests on the main engine: /api/v1/tts on the solo route at
     heads 2 and 5, a burst of three coalesced into one flash batch, a
     /api/v1/tts/stream on the lane, and three /api/v1/tts with a stream
     among them on 4 slots at heads 5, 1 reserved (the slots must be
     speculative on the spec engine). Each WAV as in phase 5; launches held
     to the code's prediction (spec: attention n_layers x (prefills +
     verify blocks); MLP n_layers x verify blocks + draft heads + heads 0 on
     the blocks + heads 0 for the first tokens). Printed per route and
     mode: spec_acceptance, tokens per block forward, ms per decode step,
     RTF; the streams' TTFT and underruns. Last, every kernel shape that
     5h launched, recorded at the launch (decode attention with the
     cache_len of the forward that read the most keys), at its dtype,
     against the plain version and timed as in phases 3/3b, with its
     launches in 5h;
  5i. weight-only int8 (--quantize int8): an engine built as the
     launcher's --quantize int8 builds it, on the main weights (every
     quantized matrix must be int8 beside its f32 scale; both trees' LLM
     weight bytes printed), behind servers: /api/v1/tts on the solo route at
     heads 1, 2 and 5, a burst of three coalesced into one flash batch, a
     /api/v1/tts/stream on the lane, three /api/v1/tts with a stream among
     them on 4 slots (1 reserved), and one request at heads 2 on an int8
     engine with --spec-decode. Each WAV as in phase 5; launches held per
     route (decode attention as before; kernel 2's int8 form where the
     dense form ran, and the dense form not at all); the counts are set to
     0 before these routes and read after them. Beside them, the same
     seeded solo heads-2 request and slot load on the main engine: ms per
     decode step, int8 against bf16, printed. Then phase 5e's llm.pt (seed
     1) is hot-reloaded into the int8 slots while 3 senders keep them busy
     (a request in a slot at the swap): the live tree must be the
     checkpoint's, quantized. Then tools/eval_int8.py on the main weights
     (2 utterances x 100 greedy tokens: token agreement, per-head KL and
     top-1 agreement), and every shape of the int8 form that 5i launched
     against its plain version, timed beside the dense kernel on the
     dequantized weights and the torch.matmul yardstick, with its byte
     bound;
  5j. training on the card (train/, tools/bench_train.py's shapes): first
     one llm_train_step and one flow_train_step at f32 on the card and on
     the CPU from the same seeded weights, batch and draws (the full-width
     LLM at 2 layers and 2 MTP heads, the DiT at 2 blocks): loss and grad
     norm within 1e-4 relative, params within 1e-4 x (1 + |p|), the
     gradients (Adam's first moments) within 1e-4 of each leaf's largest;
     then, bf16, the full LLM (24 layers, 5 heads, the tokenizer's text
     vocab) through train_llm's loop for 12 steps at B 16, Lt 64, Ls 256,
     batches collated by the port's LLMCollator from seeded rows in memory:
     every loss and grad norm finite, after step 1 a gradient on every leaf
     (the heads' MLPs included; none on the heads' never-multiplied q/k),
     and no kernel launch in any training step; the same run cut after
     step 4 and resumed from its saved train state into a fresh loop for
     two steps, whose losses and, after step 6, whose optimizer count and
     moment norms must be the uninterrupted run's within 2e-2; 30 steps at a
     constant 1e-4 on one batch drawn from 64 codes must take the loss
     below 0.9 x its first value. The same for the flow (DiT 22 x 1024,
     dropout 0.1, CFG rate 0.2, B 16, Lt 128) through train_flow's loop:
     every leaf but rand_noise trained, rand_noise decayed by the optimizer
     alone (1 - lr x wd a step, held to the schedule), and on one batch
     whose mel is a per-code template of its tokens, the mean loss of steps
     21-30 below that of steps 1-10. Both trained trees are written as npz,
     loaded through the launcher's load_models (seeded HiFT) and served: one
     /api/v1/tts at heads 2, its launches held to the prediction. Printed:
     ms per step (median of steps 3-12), tokens (mel frames) per second,
     MFU (6 x matmul params x tokens over 989 TFLOP/s) and peak memory;
  5k. DPO on the card (train/train_dpo.py, tools/bench_train.py --which
     dpo): first one dpo_train_step at f32 on the card and on the CPU from
     the same seeded weights and batch (the reference model a copy; 5j.1's
     2-layer, 2-head config): loss, dpo_loss and grad norm within 1e-5
     relative, params within 2e-5 x (1 + |p|), the gradients within 1e-4 of
     each leaf's largest; then, bf16, the full LLM (the tokenizer's text
     vocab) through train_dpo's loop for 10 steps at B 4 pairs, Lt 64, Ls
     256, on one batch collated by the port's DPOCollator from seeded rows
     in memory, against a frozen copy of the initial policy: step 1's
     dpo_loss within 1e-3 of ln 2 and both rewards within 1e-3 of 0 (the
     policy is the reference), after step 1 a gradient on every leaf but
     the heads' q/k, on head 0's slice of each head leaf and none on heads
     1-4's, no kernel launch in any step, the reference tree bit for bit
     unchanged, and the total loss lower at step 10 than at step 1. Printed:
     ms per step, pairs per second, MFU ((6 x 2 + 2 x 2) x matmul params x
     B x (2 + Lt + Ls) over 989 TFLOP/s, JAX's count), peak memory; then
     bench_train's `--which dpo` and `--which llm --accum 2` lines;
  5l. the spec-decode readout trained on the card
     (tools/train_spec_ckpt.py's recipe, B 4, Lt 64, Ls 160, but
     READOUT_STEPS steps of its 400,
     M 256, lr 2e-3) over the launcher's seed-0 tree: its loss must fall and
     its acc rise; the artifact written to chiprun_out/spec_readout.npz and
     loaded into a fresh seed-0 draw bit for bit. Then tools/bench_spec.py's
     measurement (heads 4 against heads 1, 125 tokens of a 63-token text,
     1 rep after a warm-up) on the untrained and the trained tree: the
     trained acceptance must beat the untrained; both kernels' launches
     (counts set to 0 before the decodes, read after) must equal the
     prediction (speculative and blind decodes each by their own count),
     and every shape they launched is held against its plain version as in
     5h. Printed: acceptance, tokens per step, tokens/s and speedup for both
     readouts, and the training seconds;
  5m. HiFT GAN training on the card (train/gan.py, train/train_hift.py,
     tools/bench_train.py --which gan): first one gan_train_step at f32 on
     the card and on the CPU from the same seeded weights (the full-width
     HiFT and discriminators), batch (B 1, 8 mel frames) and vocoder draws:
     both losses and grad norms within 1e-4 relative, both models' params
     within 1e-4 x (1 + |p|) and Adam's first moments within 1e-4 of each
     leaf's largest; then train_hift's loop at full width, f32, B 4 x 32
     frames, for 12 steps over 16 seeded voiced rows in memory (8 with
     precomputed features, 8 as 16 kHz audio that featurize resamples):
     every loss and grad norm finite, after step 2 (step 1's warm-up
     learning rate is 0) every leaf of both models moved; 30 steps at a
     constant 2e-4 on one batch, whose mean mel term over steps 21-30 must
     fall below that over steps 1-10; bench_train's gan line. No GAN step
     of 5m, the card-vs-CPU one and the benchmark's included, may launch
     either kernel. Last, the trained hift_final.npz loaded through
     the launcher's load_models as the HiFT (seeded LLM and flow), equal to
     the trained tree, and one /api/v1/tts at heads 2 served from it, its
     launches held to the prediction. Printed: ms per step (median of steps
     3-12), audio seconds per second and peak memory;
  5n. the training and model-admin routes, through the port's HTTP server
     on the main engine with a TrainingManager on cuda: 64 seeded LLM rows
     (random words of a fixed list, 200-256 speech tokens over the full
     speech vocab) written by the port's dataset writer into chiprun_out/
     and read back equal, directly and through load_hf_dataset; the main
     engine's seed-0 LLM written as npz; POST /api/v1/training/start of an
     llm job on that dataset from that npz (B 8, 12 steps, logging every
     step, 2 warm-up steps): a second start while it runs must give 400,
     /api/v1/training/list must show it, its status must reach completed
     with rc 0 within ROUTE_JOB_LIMIT_S, its log must name the cuda device
     and hold 12 finite step losses, /api/v1/training/plot must be a
     990 x 550 RGB PNG (IHDR, the IDAT inflating to its rows) of 12 points;
     then a second llm job, stopped once its log shows step 2: status
     stopped, its process group gone, its pid absent from nvidia-smi's
     compute apps and the card's free memory back within 1 GiB of what it
     was before the job, within the grace period; then, with TTS_MODEL_ROOT
     at the run's directory, /api/v1/models/list must name step_12.pt as a
     train state, /api/v1/models/convert {action average, model hift} of the
     served HiFT and a second seed's as npz must complete and equal their
     f32 mean (HiFT, not the 2.9 GB LLM npz: the whole run's time limit), and
     /api/v1/models/delete must remove a file and answer 400 to ../x. The
     trained LLM (from step_12.pt, as npz) is loaded through load_models
     and served: one /api/v1/tts at heads 2, launches held; last, a speaker
     enrolled by /api/v1/speakers/add {dataset_dir} from 3 voiced 16 kHz
     rows written here, and one /api/v1/tts on it, launches held. Printed:
     seconds from start to completion, ms per step from the log (median of
     steps 3-12), the stop's seconds, the convert job's seconds;
  5o. the data-preprocessing pipeline, through the port's HTTP server on the
     main engine with a TrainingManager on cuda: a raw corpus of 8 seeded
     synthetic clips (train/synth_speech.py, speakers 300-307, utterance ids
     30000+, 4-12 s, 16 kHz WAV) in two sub-directories of chiprun_out/,
     then POST /api/v1/data/run of stage 1 (to 24 kHz), stage 2 (the native
     VAD; sidecar transcripts are then put beside the segments of 4 clips),
     stage 3 (the native ASR, no filename fallback) and stage 4 once per
     sub-directory, the two jobs at once, and stage 5 merging the two: each
     job must complete with rc 0 and the logs of stages 1-4 must name the
     cuda device (stage 1's may name ffmpeg instead, when the machine has
     it). Then each stage again in this process with --device cpu on the
     same inputs, against the route's output: stage 1 within 1 int16 step
     (and stage 1's resampling on the card against the CPU, whatever
     converted the route's); stage 2's VAD probabilities within
     PRE_VAD_ATOL and the same segments, except in a clip with a frame
     within PRE_VAD_ATOL of 0.5 (those frames counted); stage 3's rows
     equal; stage 4's tokens under 5d's margin rule, the embedding within
     5d's EMB_ATOL, the mel within 5d's MEL_ATOL in bins within 60 dB of
     the clip's loudest and within PRE_MEL_QUIET_ATOL in all; stage 5's rows
     and features equal. Stages 2-4
     also run in this process on the card, timed. Then the shipped models'
     quality bars on the card: eval_vad (2 clips, SNR 5 dB, 4 s) native F1
     above 0.8 on white and hum and above energy + 0.2, above 0.85 clean;
     NativeASR on 6 held-out clips, mean TER below 0.25. Last, a
     route-started train_flow job on the merged dataset (full-width DiT,
     B 2, 4 steps): completed, rc 0, 4 finite losses. 5o launches neither
     kernel. Printed: seconds from start to completion per stage, audio
     seconds per second of stages 2-4 in this process on the card and the
     CPU, NativeASR's ms per clip, peak memory; stage 3's first dataset is
     kept in chiprun_out/preprocess_s3a for phase 5p;
  5p. frontend-extractor, VAD and ASR training on the card: kaldi_fbank on
     four seeded voiced clips against the CPU (within EXT_FBANK_ATOL in the
     bins within 60 dB of each clip's loudest, EXT_FBANK_QUIET_ATOL in every
     bin, every bin finite), and on the speaker step's own clips (within
     EXT_FBANK_ATOL within 60 dB; the largest difference printed per 20 dB
     band below each clip's loudest); one f32 step of each model at full width
     from the same tree and batch on the card and on the CPU (the
     tokenizer at --preset reference, B 4 x 4 s; the speaker encoder, B 8 x
     3 s, 8 classes, on the CPU's kaldi fbank; the VAD, B 32 x 4 s; the
     ASR, B 8 x 4 s, 12 symbols), each with its trainer's optimizer: losses
     within EXT_LOSS_REL, Adam's moments within EXT_MOMENT_TOL of each
     leaf's largest, except that where
     the card and the CPU put a ReLU input on two sides of 0 (each such input
     within EXT_FLIP_Z of its layer's largest, a rounding flip) the leaves
     of the ReLU stack are held to EXT_FLIP_TOL; the same steps on the card
     again with TF32 on for matmuls and cuDNN convs, their readings printed
     beside the gates (not gated: a lower-precision step that the gates must
     see); each trainer's main in this
     process for 15 steps at the CLI's shapes (the VAD and ASR pools cut to
     EXT_POOLS), timed (ms per step, the median of steps 3-12, synced; audio
     s/s; peak memory), steps 13-15 traced by torch.profiler, unsynced
     (per step: wall, device busy and idle share, launches, host syncs, the
     host and device ms of the train.loss_grad and train.optimizer ranges,
     the top kernels), its files loaded by the port's loaders on the card
     equal to the trained tree (fp16 where the trainer stores fp16); the
     four CLIs (train_frontend tokenizer and speaker at --preset shipped on
     a 64-utterance corpus, train_vad and train_asr on EXT_POOLS through
     their --speech_pool / --pool and --noise_pool flags) for 40 steps
     and train_asr --dataset on 5o's stage-3 dataset for 4, as
     subprocesses at once on the card, beside the in-process steps above
     (which share the host's cores with them): rc 0, the cuda device in each log,
     every logged loss finite, and in the first four the mean loss of the
     last 10 steps below that of the first 10; the card-trained tokenizer
     and speaker encoder then serve one /api/v1/zero-shot request at heads
     2 through the main engine, prompted by a 3 s clip of the demo set that
     tools/make_demo_samples.py writes into chiprun_out/ (launches held);
     eval_frontend_real on that set with the trained and the shipped
     extractors, eval_vad and eval_asr with the trained VAD and ASR
     (printed, no bar). No training step launches either kernel;
  5q. the serving tools: the launcher (`python -m
     flowmirror_hydravox_tpu_torch --with-ui --max-tokens 300`, 4 slots by
     default) as a subprocess on the card; GET / must be the page
     (text/html), its I18N en and zh tables must hold the same keys and
     every data-i18n marker, /api/v1/devices must report one gpu, and every
     route the page calls must answer with a status other than 404 (a
     speaker added from a 3 s voiced clip and removed, a /tts and a
     /zero-shot request, a stage-5 data job that fails on a missing
     directory for the training status, plot and stop routes, the rest
     with bodies they refuse); tools/loadgen.py's CLI against it, closed
     /tts then Poisson /tts/stream, LOADGEN_S each: requests > 0, errors 0,
     continuous_requests rising; the launcher stopped (SIGINT, then
     SIGKILL). That part launches no kernel in this process and runs on a
     thread beside phase 5o (the whole run's time limit). Then
     tools/bench_serving.py at full width (BENCH_ARGS, its own engine,
     max_tokens 1024), as a subprocess started with phase 5o and running
     beside 5o and 5p (so its figures read a card and a host that those
     phases share; `python -m flowmirror_hydravox_tpu_torch.tools.
     bench_serving` alone measures them): every scenario line in the JAX
     order, none skipped or failed, errors 0 but in the capacity probe
     (printed), and both kernels launched during it, as its last line
     counts them in its process (those launches join the kernels line).
     Last, CausalHiFT on the served HiFT (f32) and
     on its voiced copy (every frame voiced: the source's sine half in the
     waveform) at CAUSAL_SECONDS of seeded mel with seeded fixed noise, each
     card against the CPU within CAUSAL_TOL, finalize on and off, and calls
     on a growing prefix (CAUSAL_CHUNK frames a step) on the card within
     CAUSAL_PREFIX_TOL of the whole; ms per call beside the non-causal
     inference; no launch;
  6. the kernels line (launches: phases 5 to 5q; the int8 form's: 5i), the
     card line, and the final JSON line.

TF32 is off for matmuls and cuDNN convs throughout, so f32 is full f32 in
every comparison, and cuDNN takes deterministic algorithms, so a seeded
request repeats bit for bit. Measurements also go to
chiprun_out/chip_smoke.json.
"""

import base64
import contextlib
import io
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
import wave

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
MAX_TOKENS = 300  # bounds each request's decode so the run stays short
BURST_WINDOW = 0.25  # s: the coalescing window of the burst's server
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core f32, dense bf16
N_TIMED = 20
FLUSH_WRITES = 16


def fail(msg: str):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def census() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, flush):
    """Median per-call device time over N_TIMED calls, L2 flushed before each.
    The flush is written FLUSH_WRITES times (~1.4 ms of device work), so the
    host has queued the call before its start event fires and the host's
    dispatch time stays out of the measurement, even for the plain versions'
    dozens of small ops on a busy host."""
    import torch

    for _ in range(3):
        fn()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(N_TIMED)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(N_TIMED)]
    for s, e in zip(starts, ends):
        for _ in range(FLUSH_WRITES):
            flush.zero_()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def attention_bound(q, k, cache_len):
    """(bound_ms, bound_by): bytes (q, valid K/V rows, out) over HBM rate vs
    operations over the peak rate of the inputs' type, for these inputs."""
    b, t, hq, d = q.shape
    s_max, hkv = k.shape[1], k.shape[2]
    es = q.element_size()
    lens = cache_len.tolist()
    kv_rows = sum(min(c + t, s_max) for c in lens)
    nbytes = 2 * q.numel() * es + 2 * kv_rows * hkv * d * es + 4 * b
    flops = sum(4 * hq * d * min(c + i + 1, s_max) for c in lens for i in range(t))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(q.dtype).replace("torch.", "")]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# (B, T, S_max, cache_len, Hq): the main path's shapes (Hq 14, Hkv 2, D 64;
# decode T in {1, 2, 5}, prefill blocks of ~130 and of the requests' prompt
# bucket; B 1, 3 and 4 for flash batches; cache_len around the 32-key
# tiles and 128-key splits), then the edges of the kernel's design: G * T
# of 16 (Hq 16); the last key at the end of a split of a 1024-key cache
# and one past it; rows with no key in the next split; the last key at
# S_max - T; a row with cache_len 0 in a batch of 3. Last, the continuous
# slots' shapes: a slot step (B 4 slots, T 2, an empty slot at cache_len 0)
# against the cache of --max-tokens 300 (768 rows) and of the default 1024
# (1536 rows), and the admission prefill of a 128-token text at B 1
ATTENTION_CASES = [(1, 1, 512, [0], 14), (1, 1, 512, [127], 14), (1, 2, 512, [128], 14),
                   (1, 2, 512, [255], 14), (1, 5, 512, [383], 14), (1, 66, 512, [0], 14),
                   (1, 130, 512, [0], 14), (3, 1, 768, [31, 256, 700], 14),
                   (3, 5, 768, [32, 511, 600], 14), (4, 2, 512, [40, 129, 300, 509], 14),
                   (1, 2, 512, [200], 16), (1, 2, 1024, [511], 14), (1, 1, 1024, [512], 14),
                   (1, 5, 1024, [509], 14), (1, 2, 512, [510], 14), (3, 2, 512, [0, 300, 77], 14),
                   (4, 2, 768, [0, 37, 300, 700], 14), (4, 2, 1536, [0, 130, 900, 1500], 14),
                   (1, 130, 768, [0], 14), (1, 2, 768, [140], 14)]
# tolerance relative to 1 + max |plain|, by dtype
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def check_decode_attention(da, flush, cases, dtypes=("bfloat16", "float32")):
    """Phase 3: every case (B, T, S_max, cache_len, Hq) at each of `dtypes`
    against the plain version, twice (the two calls must be bit-equal),
    timed. Returns the per-case records."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(0)
    records = []
    for dtype in (getattr(torch, d) for d in dtypes):
        for b, t, s_max, lens, hq in cases:
            q = torch.randn(b, t, hq, 64, generator=g, device="cuda").to(dtype)
            k = torch.randn(b, s_max, 2, 64, generator=g, device="cuda").to(dtype)
            v = torch.randn(b, s_max, 2, 64, generator=g, device="cuda").to(dtype)
            cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
            out = da.decode_attention_cuda(q, k, v, cl)
            torch.cuda.synchronize()
            ref = da.decode_attention_ref(q, k, v, cl)
            err = (out.float() - ref.float()).abs().max().item()
            lim = TOL[str(dtype).replace("torch.", "")] * (1.0 + ref.float().abs().max().item())
            if not err <= lim:
                fail(f"decode_attention {dtype} B{b} T{t} S{s_max} Hq{hq} {lens}: "
                     f"err {err} > {lim}")
            if not torch.equal(da.decode_attention_cuda(q, k, v, cl), out):
                fail(f"decode_attention {dtype} B{b} T{t} S{s_max} Hq{hq} {lens}: "
                     f"two calls differ")
            pos = torch.arange(s_max, device="cuda")[None, None, :]
            bias = torch.where(pos <= cl[:, None, None] + torch.arange(t, device="cuda")[None, :, None],
                               0.0, da.NEG_INF).to(dtype)[:, None]
            qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
            rec = dict(
                dtype=str(dtype).replace("torch.", ""), B=b, T=t, S_max=s_max, Hq=hq,
                cache_len=lens, max_abs_err=err,
                kernel_ms=time_ms(lambda: da.decode_attention_cuda(q, k, v, cl), flush),
                ref_ms=time_ms(lambda: da.decode_attention_ref(q, k, v, cl), flush),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=bias, enable_gqa=True), flush),
            )
            rec["library_ratio"] = rec["kernel_ms"] / rec["library_ms"]
            rec["bound_ms"], rec["bound_by"] = attention_bound(q, k, cl)
            records.append(rec)
            print("decode_attention", json.dumps(rec), flush=True)
    return records


def mlp_bound(m: int, h: int, i: int, dtype) -> tuple:
    """(bound_ms, bound_by) of the fused MLP: bytes (x, the three weights and
    the output, each once) over the HBM rate vs operations (6 M H I for the
    three products, 4 M I for silu and the product) over the type's peak."""
    es = dtype.itemsize
    nbytes = (2 * m * h + 3 * h * i) * es
    flops = 6 * m * h * i + 4 * m * i
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# (M, H, I): the backbone decode MLP at M = B x K rows (1, 2, 5 for a single
# request at heads 1, 2, 5; 4, 6, 8 for the main path's batches at heads 2;
# 10 and 40 for B 2 and 8 at heads 5) and the MTP heads' at M = B
MLP_CASES = [(m, 896, 4864) for m in (1, 2, 4, 5, 6, 8, 10, 40)] + \
            [(m, 896, 22016) for m in (1, 2, 3, 4, 8)]
# the edges of the kernel's design, checked and timed beside them: one row
# past a row group (9), two groups (16), more rows than one block holds
# (65), a ragged I (4864 + 8, odd 4863)
MLP_EDGE_CASES = [(9, 896, 4864), (16, 896, 4864), (65, 896, 4864), (2, 896, 4872),
                  (3, 896, 4863)]
# the spec verify blocks at K 5 before phase 5h serves them: kernel 1 at
# T = K = 5 for one request (B 1) and for 4 slots at K 5 (B 4, diverging
# cache lengths); kernel 2 at M = B x K of the backbone and of head 0 on the
# block (5: one request; 20: 4 slots; 40: the 8 rows of the largest flash
# batch, which 5h's 3-row burst does not reach). Phase 5h then records the
# shape of every launch it makes and holds each one against the plain
# version (check_served_shapes)
SPEC_ATTENTION_CASES = [(1, 5, 512, [383], 14), (4, 5, 768, [37, 211, 402, 650], 14)]
SPEC_MLP_CASES = [(5, 896, 4864), (20, 896, 4864), (40, 896, 4864), (5, 896, 22016),
                  (20, 896, 22016), (40, 896, 22016)]


def check_mlp_gemv(mg, flush, cases, dtypes=("bfloat16", "float32")):
    """Phase 3b: every case (M, H, I) at each of `dtypes`, as phase 3.
    Returns the per-case records."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(2)
    records = []
    for dtype in (getattr(torch, d) for d in dtypes):
        for m, h, i in cases:
            x = torch.randn(m, h, generator=g, device="cuda").to(dtype)
            gate, up, down = (
                (torch.randn(shape, generator=g, device="cuda") * 0.05).to(dtype)
                for shape in ((h, i), (h, i), (i, h)))
            out = mg.mlp_gemv_cuda(x, gate, up, down)
            torch.cuda.synchronize()
            ref = mg.mlp_gemv_ref(x, gate, up, down).float()
            err = (out.float() - ref).abs().max().item()
            lim = TOL[str(dtype).replace("torch.", "")] * (1.0 + ref.abs().max().item())
            if not err <= lim:
                fail(f"mlp_gemv {dtype} M{m} H{h} I{i}: err {err} > {lim}")
            if not torch.equal(mg.mlp_gemv_cuda(x, gate, up, down), out):
                fail(f"mlp_gemv {dtype} M{m} H{h} I{i}: two calls differ")
            rec = dict(
                dtype=str(dtype).replace("torch.", ""), M=m, H=h, I=i, max_abs_err=err,
                kernel_ms=time_ms(lambda: mg.mlp_gemv_cuda(x, gate, up, down), flush),
                ref_ms=time_ms(lambda: mg.mlp_gemv_ref(x, gate, up, down), flush),
                # a yardstick, not one call: no single PyTorch call computes
                # this function
                library_ms=time_ms(lambda: (F.silu(x @ gate) * (x @ up)) @ down, flush),
            )
            rec["library_ratio"] = rec["kernel_ms"] / rec["library_ms"]
            rec["bound_ms"], rec["bound_by"] = mlp_bound(m, h, i, dtype)
            records.append(rec)
            print("mlp_gemv", json.dumps(rec), flush=True)
    return records


def check_backbone(engine):
    """Phase 4: the full-width Qwen2 backbone, f32, on the card (through both
    kernels) and on the CPU (plain versions): a prefill of 66 and two decode
    blocks at B 1, then a flash-batch prefill and two decode blocks at B 3,
    K 2 with per-row lengths (the second with one row finished, advance 0).
    Returns the larger relative error."""
    import torch

    from flowmirror_hydravox_tpu_torch.models import qwen2

    cfg = engine.cfg.llm.backbone
    bb = engine.llm_params["backbone"]
    on_card = {"layers": {k: v.float() for k, v in bb["layers"].items()}, "norm": bb["norm"].float()}
    on_cpu = {"layers": {k: v.cpu() for k, v in on_card["layers"].items()},
              "norm": on_card["norm"].cpu()}
    g = torch.Generator().manual_seed(1)
    runs = {  # (batch, [(block, advance, decode_step)])
        "B1": (1, [(torch.randn(1, n, cfg.hidden_size, generator=g) * 0.5, [n], n == 2)
                   for n in (66, 2, 2)]),
        "B3": (3, [(torch.randn(3, 40, cfg.hidden_size, generator=g) * 0.5, [40, 17, 29], False),
                   (torch.randn(3, 2, cfg.hidden_size, generator=g) * 0.5, [2, 2, 2], True),
                   (torch.randn(3, 2, cfg.hidden_size, generator=g) * 0.5, [2, 0, 2], True)]),
    }
    worst = 0.0
    for run, (batch, blocks) in runs.items():
        outs = {}
        for name, params, dev in (("card", on_card, "cuda"), ("cpu", on_cpu, "cpu")):
            cache = qwen2.init_kv_cache(cfg, batch, 256, dtype=torch.float32, device=dev)
            hs = []
            for x, adv, decode_step in blocks:
                h, cache = qwen2.forward_block_with_cache(
                    params, cfg, x.to(dev), cache,
                    advance=torch.tensor(adv, dtype=torch.int32, device=dev),
                    decode_step=decode_step)
                hs.append(h.cpu())
            outs[name] = torch.cat(hs, dim=1)
        rel = ((outs["card"] - outs["cpu"]).norm() / outs["cpu"].norm()).item()
        print(f"backbone full width f32 {run}, card (kernels) vs CPU (plain): "
              f"relative error {rel:.3e}", flush=True)
        if not rel <= 1e-4:
            fail(f"full-width backbone {run} disagrees with the CPU plain path: {rel}")
        worst = max(worst, rel)
    return worst


TEXTS = {  # name: (text, heads, the engine route, rows)
    "heads1": ("Hello, this sentence is spoken by the first head only.", 1, "synthesize", 1),
    "two_segments": ("The quick brown fox jumps over the lazy dog! "
                     "Then a second sentence follows the first one.", 2, "synthesize_batch", 2),
    "heads5": ("Five heads decode this request in groups of five.", 5, "synthesize", 1),
    "four_segments": ("Here is the first part of this longer request! Is this the second part "
                      "of it? Yes, and a third part follows; the fourth part closes the whole "
                      "request.", 2, "synthesize_batch", 4),
}
BURST = ["A short burst request arrives first.", "Another burst request comes right behind it.",
         "The third burst request completes the group."]


def http_call(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data, {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        return r.status, json.load(r)


def tts(base, text, heads, **extra):
    """POST /api/v1/tts; the WAV must be 24 kHz, non-empty and finite.
    Returns (samples, peak)."""
    code, body = http_call(base, "/api/v1/tts", {
        "text": text, "speaker_id": "default",
        "extra_params": {"inference_head_num": heads, **extra}})
    if code != 200 or not body.get("success"):
        raise RuntimeError(f"/api/v1/tts heads={heads}: {code} {body.get('error')}")
    with wave.open(io.BytesIO(base64.b64decode(body["data"]["audio_base64"]))) as w:
        rate, frames = w.getframerate(), w.readframes(w.getnframes())
    pcm = np.frombuffer(frames, np.int16).astype(np.float32) / 32768.0
    if rate != 24000 or pcm.size == 0 or not np.isfinite(pcm).all():
        raise RuntimeError(f"bad WAV for heads={heads}: rate {rate}, {pcm.size} samples")
    return pcm.size, float(np.abs(pcm).max())


def predicted_launches(recs, cfg):
    """(attention, MLP) launches of the engine calls `recs`: every step runs
    the MTP heads (one MLP launch per head) and every step but the last a
    decode-step forward (the stopping step runs none, llm.py); with the
    prefill, `steps` backbone forwards in all, each one attention launch per
    layer, the decode-step ones one MLP launch per layer."""
    n_layers = cfg.backbone.num_layers
    heads = [max(1, min(int(r["heads"]), cfg.head_num)) for r in recs]
    attention = sum(n_layers * r["steps"] for r in recs)
    mlp = sum(n_layers * (r["steps"] - 1) + k * r["steps"] for r, k in zip(recs, heads))
    return attention, mlp


class EngineCalls:
    """While entered, records each call of `Engine.synthesize` and
    `Engine.synthesize_batch` (the worker's routes) in `records`; a record
    holds the (T, S_max) of each LM prefill the call ran, read from the
    prompt block and the KV cache that `llm.init_generate_state` or
    `llm.generate_batched` was given and allocated, and the stage-2 token
    bucket with the rule that chose it (estimated or realised)."""

    def __init__(self, engine):
        self.engine = engine
        self.records = []

    def __enter__(self):
        from flowmirror_hydravox_tpu_torch.models import llm as llm_model

        synthesize, synthesize_batch = self.engine.synthesize, self.engine.synthesize_batch
        init_state, batched = llm_model.init_generate_state, llm_model.generate_batched
        init_kv = llm_model.qwen2.init_kv_cache
        self.saved = synthesize, synthesize_batch, init_state, batched, init_kv
        local = threading.local()

        def record_init(params, cfg, prompt_embeds, prompt_len, **kwargs):
            state = init_state(params, cfg, prompt_embeds, prompt_len, **kwargs)
            getattr(local, "prefills", []).append(
                (int(prompt_embeds.shape[0]), int(state["cache"].k.shape[2])))
            return state

        def record_kv(cfg, batch, max_len, **kwargs):
            if hasattr(local, "kv"):
                local.kv.append(int(max_len))
            return init_kv(cfg, batch, max_len, **kwargs)

        def record_batched(params, cfg, prompt_embeds, *args, **kwargs):
            local.kv = []
            try:
                res = batched(params, cfg, prompt_embeds, *args, **kwargs)
                getattr(local, "prefills", []).append((int(prompt_embeds.shape[1]), local.kv[0]))
            finally:
                del local.kv
            return res

        def record_one(**kwargs):
            local.prefills = []
            try:
                res = synthesize(**kwargs)
                prefills = local.prefills
            finally:
                del local.prefills
            self.records.append(dict(route="synthesize", rows=1,
                                     heads=kwargs["inference_head_num"],
                                     prefills=prefills,
                                     tokens=len(res.speech_tokens), steps=res.steps,
                                     row_tokens=[len(res.speech_tokens)],
                                     token_bucket=res.token_bucket, estimated=res.estimated,
                                     spec_acceptance=res.spec_acceptance,
                                     llm_time=res.llm_time, synth_time=res.synth_time,
                                     total_time=res.total_time))
            return res

        def record_batch(token_lists, **kwargs):
            local.prefills = []
            try:
                wavs, stats = synthesize_batch(token_lists, **kwargs)
                prefills = local.prefills
            finally:
                del local.prefills
            self.records.append(dict(route="synthesize_batch", rows=len(token_lists),
                                     heads=kwargs["inference_head_num"], prefills=prefills,
                                     tokens=sum(stats["tokens"]), steps=stats["steps"],
                                     row_tokens=list(stats["tokens"]),
                                     token_bucket=stats["token_bucket"],
                                     estimated=stats["estimated"],
                                     spec_acceptance=stats["spec_acceptance"],
                                     llm_time=stats["llm_time"], synth_time=stats["synth_time"],
                                     total_time=stats["total_time"]))
            return wavs, stats

        self.engine.synthesize, self.engine.synthesize_batch = record_one, record_batch
        llm_model.init_generate_state, llm_model.generate_batched = record_init, record_batched
        llm_model.qwen2.init_kv_cache = record_kv
        return self

    def __exit__(self, *exc):
        from flowmirror_hydravox_tpu_torch.models import llm as llm_model

        (self.engine.synthesize, self.engine.synthesize_batch, llm_model.init_generate_state,
         llm_model.generate_batched, llm_model.qwen2.init_kv_cache) = self.saved


def start_servers(engine, frontend, **kwargs_list):
    """One HTTP server on 127.0.0.1 per keyword (its make_server kwargs),
    each serving on its own thread. Returns {name: (server, thread, url)}."""
    from flowmirror_hydravox_tpu_torch.runtime.server import make_server

    out = {}
    for name, kwargs in kwargs_list.items():
        server = make_server("127.0.0.1", 0, engine, frontend, request_timeout=600.0, **kwargs)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        out[name] = (server, thread, f"http://127.0.0.1:{server.server_address[1]}")
    return out


def stop_servers(servers):
    for server, thread, _ in servers.values():
        server.shutdown()
        server.RequestHandlerClass.service.shutdown()
        server.server_close()
        thread.join(timeout=10)


def drive_main_path(engine, frontend, da, mg):
    """Phase 5: the requests through two servers, one with the default
    window and one with BURST_WINDOW. Returns (requests, launches)."""
    cfg = engine.cfg.llm

    def measure(name, run, routes, heads):
        """Run one request (or the burst), check its routes and both
        kernels' launch counts, and return its record."""
        before = (da.launch_count, mg.launch_count, len(calls.records))
        t0 = time.time()
        try:
            wavs = run()
        except (RuntimeError, OSError) as e:
            fail(f"{name}: {e}")
        wall = time.time() - t0
        recs = calls.records[before[2]:]
        if [(r["route"], r["rows"]) for r in recs] != routes:
            fail(f"{name}: engine calls {[(r['route'], r['rows']) for r in recs]}, "
                 f"expected {routes}")
        launched = (da.launch_count - before[0], mg.launch_count - before[1])
        if launched != predicted_launches(recs, cfg) or 0 in launched:
            fail(f"{name}: (attention, mlp) launches {launched}, "
                 f"predicted {predicted_launches(recs, cfg)}")
        audio_s = sum(n for n, _ in wavs) / 24000.0
        req = dict(
            name=name, heads=heads, route=routes[0][0], rows=routes[0][1],
            requests=len(wavs), tokens=sum(r["tokens"] for r in recs),
            steps=sum(r["steps"] for r in recs), llm_time=sum(r["llm_time"] for r in recs),
            synth_time=sum(r["synth_time"] for r in recs), wall_s=wall, audio_s=audio_s,
            peak=max(p for _, p in wavs), attention_launches=launched[0],
            mlp_launches=launched[1],
        )
        req["tps"] = req["tokens"] / req["llm_time"]
        req["rtf"] = sum(r["total_time"] for r in recs) / audio_s
        print("request", json.dumps(req), flush=True)
        return req

    def burst():
        out, errors = [None] * len(BURST), []

        def one(i):
            try:
                out[i] = tts(burst_url, BURST[i], 2)
            except Exception as e:  # reported by the caller
                errors.append(f"burst request {i}: {e}")

        workers = [threading.Thread(target=one, args=(i,)) for i in range(len(BURST))]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=900)
        if errors or any(w.is_alive() for w in workers):
            raise RuntimeError("; ".join(errors) or "a burst request did not finish")
        return out

    servers = start_servers(engine, frontend, window={}, burst={"batch_window": BURST_WINDOW})
    url, burst_url = servers["window"][2], servers["burst"][2]
    requests = []
    try:
        with EngineCalls(engine) as calls:
            if http_call(url, "/health") != (200, {"status": "ok"}):
                fail("/health")
            code, body = http_call(url, "/api/v1/speakers")
            if code != 200 or body["data"]["speakers"] != ["default"]:
                fail(f"/api/v1/speakers: {code} {body}")
            # first-use cost (cuBLAS, cuDNN) of both routes outside the counted run
            for text in ("Warm up the card.", "Warm up the card! And the flash batch as well."):
                tts(url, text, 2)
            burst_service = servers["burst"][0].RequestHandlerClass.service
            da.launch_count = mg.launch_count = 0  # counts from here are the main path's
            for name, (text, heads, route, rows) in TEXTS.items():
                requests.append(measure(name, lambda: [tts(url, text, heads)], [(route, rows)],
                                        heads))
            batched = burst_service.batched_requests
            requests.append(measure("burst", burst, [("synthesize_batch", len(BURST))], 2))
            if burst_service.batched_requests - batched != len(BURST):
                fail(f"the burst was not one coalesced group: batched_requests rose by "
                     f"{burst_service.batched_requests - batched}")
            launches = (da.launch_count, mg.launch_count)
            if launches != (sum(r["attention_launches"] for r in requests),
                            sum(r["mlp_launches"] for r in requests)):
                fail("launch counts changed outside the requests")
            return requests, launches
    finally:
        stop_servers(servers)


# phase 5b: one-sentence requests sent STAGGER_GAP s apart, more than the
# slots hold
STAGGER = ["The first caller asks for a short weather report.",
           "A second caller wants the opening hours of the library.",
           "The third request reads a line from a story for children.",
           "Here the fourth caller orders a taxi to the station.",
           "A fifth voice announces that the train is running late.",
           "The sixth and last request says goodbye to everyone."]
STAGGER_GAP = 0.15
SLOTS = 4


def staggered(base, texts):
    """One request per text, STAGGER_GAP s apart, each on its own thread;
    request i carries seed 1000 + i, so both modes decode the same draws.
    Returns ([(latency s, samples, peak)], wall s from the first send to the
    last answer)."""
    out, errors = [None] * len(texts), []

    def one(i):
        t0 = time.time()
        try:
            n, peak = tts(base, texts[i], 2, seed=1000 + i)
            out[i] = (time.time() - t0, n, peak)
        except Exception as e:  # reported below
            errors.append(f"request {i}: {e}")

    workers = [threading.Thread(target=one, args=(i,)) for i in range(len(texts))]
    t0 = time.time()
    for i, w in enumerate(workers):
        if i:
            time.sleep(STAGGER_GAP)
        w.start()
    for w in workers:
        w.join(timeout=900)
    if errors or any(w.is_alive() for w in workers):
        fail("staggered load: " + ("; ".join(errors) or "a request did not finish"))
    return out, time.time() - t0


def load_summary(mode, out, wall, tokens, steps, step_s, synth_s, launched):
    """One load's figures: per-request latency, tokens/s over the load, ms
    per decode step (decode time / steps), and the seconds spent in flow +
    HiFT."""
    lat = [o[0] for o in out]
    rec = dict(mode=mode, requests=len(out), latency_p50_s=float(np.percentile(lat, 50)),
               latency_p95_s=float(np.percentile(lat, 95)), latencies_s=lat, wall_s=wall,
               audio_s=sum(o[1] for o in out) / 24000.0, tokens=tokens,
               tokens_per_s=tokens / wall, steps=steps, ms_per_step=1e3 * step_s / steps,
               synth_s=synth_s, attention_launches=launched[0], mlp_launches=launched[1])
    print("load", json.dumps(rec), flush=True)
    return rec


def drive_continuous(engine, frontend, da, mg):
    """Phase 5b: the STAGGER load against a window-mode server, then against
    a server with SLOTS continuous slots at heads 2 (the launcher's default),
    followed there by a four-segment text (four slot requests) and, on its
    own, a request at top_p 0.5 and heads 1, which the worker serves. Holds
    the launches of each part to the code's prediction. Returns
    (results, launches)."""
    cfg = engine.cfg.llm
    n_layers = cfg.backbone.num_layers
    servers = start_servers(engine, frontend, window={},
                            continuous={"continuous_slots": SLOTS, "continuous_head_num": 2})
    window_url, cont_url = servers["window"][2], servers["continuous"][2]
    service = servers["continuous"][0].RequestHandlerClass.service
    batcher = service.batcher
    submitted = []
    submit = batcher.submit

    def record_submit(*args, **kwargs):
        req = submit(*args, **kwargs)
        submitted.append(req)
        return req

    batcher.submit = record_submit
    try:
        with EngineCalls(engine) as calls:
            tts(cont_url, "Warm up the decode slots.", 2)  # the slots' state is made here

            # the window mode, for comparison
            del calls.records[:]
            da.launch_count = mg.launch_count = 0
            out, wall = staggered(window_url, STAGGER)
            launched = (da.launch_count, mg.launch_count)
            recs = list(calls.records)
            if launched != predicted_launches(recs, cfg) or 0 in launched:
                fail(f"window load: launches {launched}, predicted "
                     f"{predicted_launches(recs, cfg)}")
            window = load_summary("window", out, wall, sum(r["tokens"] for r in recs),
                                  sum(r["steps"] for r in recs),
                                  sum(r["llm_time"] for r in recs),
                                  sum(r["synth_time"] for r in recs), launched)
            window["engine_calls"] = [(r["route"], r["rows"]) for r in recs]

            # the continuous slots: the load, then a four-segment text
            del calls.records[:], submitted[:]
            before = dict(batcher.stats)
            served = service.continuous_requests
            da.launch_count = mg.launch_count = 0
            out, wall = staggered(cont_url, STAGGER)
            after_load = dict(batcher.stats)
            load_reqs = list(submitted)
            four = tts(cont_url, TEXTS["four_segments"][0], 2)
            launched = (da.launch_count, mg.launch_count)
            done = {k: batcher.stats[k] - before[k] for k in before}
            prediction = (n_layers * (done["admits"] + done["forwards"]),
                          n_layers * done["forwards"] + batcher.head_k * done["steps"])
            if launched != prediction or 0 in launched:
                fail(f"continuous: launches {launched}, predicted {prediction} from {done}")
            if calls.records:
                fail(f"continuous: the worker served {calls.records}")
            if len(submitted) != len(STAGGER) + 4 or done["admits"] != len(submitted):
                fail(f"continuous: {len(submitted)} slot requests, {done['admits']} admits")
            code, body = http_call(cont_url, "/api/v1/metrics")
            metrics = body["data"]
            if code != 200 or metrics["continuous_requests"] - served != len(STAGGER) + 1:
                fail(f"continuous: /api/v1/metrics {code} {metrics}")
            if "admission_ms_p50" not in metrics:
                fail("continuous: /api/v1/metrics has no admission_ms_p50")
            joins = [(a.t_admit, b.t_admit, a.t_decoded) for a in submitted for b in submitted
                     if a is not b and a.t_admit < b.t_admit < a.t_decoded]
            if not joins:
                fail("continuous: no request was admitted while another slot was decoding")
            cont = load_summary(
                "continuous", out, wall, sum(len(r.stats["tokens"]) for r in load_reqs),
                after_load["steps"] - before["steps"],
                after_load["decode_s"] - before["decode_s"],
                sum(r.stats["synth_time"] for r in load_reqs), launched)
            cont.update(four_segment_samples=four[0], joins_in_flight=len(joins),
                        batcher_stats=done, admission_ms_p50=metrics["admission_ms_p50"],
                        admission_ms_p95=metrics["admission_ms_p95"],
                        admission_s=[r.t_admit - r.t_submit for r in submitted])
            print("continuous", json.dumps({k: cont[k] for k in (
                "joins_in_flight", "batcher_stats", "admission_ms_p50", "admission_ms_p95")}),
                flush=True)

            # a request the slots do not serve goes through the worker
            da.launch_count = mg.launch_count = 0
            tts(cont_url, STAGGER[0], 1, top_p=0.5)
            worker_launched = (da.launch_count, mg.launch_count)
            recs = list(calls.records)
            if [(r["route"], r["rows"]) for r in recs] != [("synthesize", 1)]:
                fail(f"worker request: engine calls {recs}")
            if worker_launched != predicted_launches(recs, cfg) or 0 in worker_launched:
                fail(f"worker request: launches {worker_launched}, predicted "
                     f"{predicted_launches(recs, cfg)}")
            if service.continuous_requests - served != len(STAGGER) + 1:
                fail("worker request: continuous_requests changed")
        total = tuple(a + b + c for a, b, c in zip(
            (window["attention_launches"], window["mlp_launches"]), launched, worker_launched))
        return dict(window=window, continuous=cont, worker_launches=worker_launched), total
    finally:
        batcher.submit = submit
        stop_servers(servers)


# phase 5c: streams
STREAM_TEXT = "Streaming speech starts to play before the whole sentence is ready."
STREAM_TWO = "The stream speaks this first sentence! Then it goes on with a second one."
STREAM_PAIR = ["Two streams can share the decode slots at once.",
               "The second of them arrives at the very same moment."]
STREAM_SEED = 4242
SAMPLE_RATE = 24000
DEFAULT_WIN = 24  # the tts default win_size, the continuous slots' sampling
SAMPLES_PER_TOKEN = 2 * 480  # token_mel_ratio x HiFT upsampling, HydraVoxConfig()


def jax_stream_header(sr: int) -> bytes:
    """The JAX server's live-WAV header (server.py:1335-1339), spelled out."""
    return (b"RIFF" + (0xFFFFFFFF).to_bytes(4, "little") + b"WAVEfmt "
            + (16).to_bytes(4, "little") + (1).to_bytes(2, "little") + (1).to_bytes(2, "little")
            + sr.to_bytes(4, "little") + (2 * sr).to_bytes(4, "little")
            + (2).to_bytes(2, "little") + (16).to_bytes(2, "little")
            + b"data" + (0xFFFFFFFF).to_bytes(4, "little"))


def tts_stream(base, text, seed, heads=2, **extra):
    """POST /api/v1/tts/stream; the header must be the JAX server's bytes,
    the PCM non-empty. Returns the s16 PCM."""
    body = json.dumps({"text": text, "speaker_id": "default",
                       "extra_params": {"inference_head_num": heads, "seed": seed, **extra}})
    req = urllib.request.Request(base + "/api/v1/tts/stream", body.encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=900) as r:
        if r.status != 200 or r.headers["Content-Type"] != "audio/wav":
            raise RuntimeError(f"/api/v1/tts/stream: {r.status} {r.headers['Content-Type']}")
        data = r.read()
    if data[:44] != jax_stream_header(SAMPLE_RATE):
        raise RuntimeError(f"stream header {data[:44]!r} is not the JAX server's")
    pcm = np.frombuffer(data[44:], "<i2")
    if pcm.size == 0 or not np.isfinite(pcm.astype(np.float32)).all():
        raise RuntimeError(f"bad stream PCM: {pcm.size} samples")
    return pcm


class StreamWatch:
    """While entered, records every stream: for each stream task a service
    receives, its seed, its submit time, the time and samples of each item put
    on its chunk queue and the slot requests submitted for it (`streams`); the
    slot requests in order (`slot_requests`); and each lane session's record
    (tokens, steps, chunks) in `sessions`."""

    def __init__(self, engine, services):
        self.streamer = engine.streaming()
        self.services = services
        self.sessions, self.streams, self.slot_requests = [], [], []
        self._last_req = {}  # thread -> the slot request it submitted last

    def __enter__(self):
        synthesize_stream = self.streamer.synthesize_stream

        def record(*args, **kwargs):
            session = {}
            self.sessions.append(session)
            yield from synthesize_stream(*args, session=session, **kwargs)

        self.streamer.synthesize_stream = record
        for service in self.services:
            self._watch(service)
        return self

    def _watch(self, service):
        submit = service.submit

        def watched(task):
            if task.get("type") == "tts_stream":
                rec = dict(seed=task["extra_params"].get("seed"), t_submit=time.time(), puts=[],
                           reqs=[])
                q = task["chunk_queue"]
                put = q.put

                def timed_put(item, *args, **kwargs):
                    # a slot stream's segments are submitted and read on one
                    # pool thread, so its chunks come from its last request
                    req = self._last_req.get(threading.get_ident())
                    if req is not None and req.stream and all(r is not req for r in rec["reqs"]):
                        rec["reqs"].append(req)
                    rec["puts"].append((time.time(), len(item) // 2
                                        if isinstance(item, bytes) else None))
                    put(item, *args, **kwargs)

                q.put = timed_put
                self.streams.append(rec)
            return submit(task)

        service.submit = watched
        if service.batcher is not None:
            batcher_submit = service.batcher.submit

            def watched_submit(*args, **kwargs):
                req = batcher_submit(*args, **kwargs)
                self.slot_requests.append(req)
                self._last_req[threading.get_ident()] = req
                return req

            service.batcher.submit = watched_submit

    def clear(self):
        del self.sessions[:], self.streams[:], self.slot_requests[:]

    def __exit__(self, *exc):
        del self.streamer.synthesize_stream
        for service in self.services:
            del service.submit
            if service.batcher is not None:
                del service.batcher.submit


def stream_timing(rec):
    """Time to first audio, the gaps between chunks and the underruns of one
    stream, from its chunk queue (a pause between segments is audio too):
    playback starts with the first chunk, and a chunk that arrives after the
    audio before it has played out is an underrun."""
    chunks = [(t, n) for t, n in rec["puts"] if n is not None]
    t0 = chunks[0][0]
    played, underruns = 0.0, 0
    for t, n in chunks:
        underruns += t > t0 + played
        played += n / SAMPLE_RATE
    return dict(ttft_s=t0 - rec["t_submit"],
                gaps_s=[b[0] - a[0] for a, b in zip(chunks, chunks[1:])],
                underruns=underruns, audio_s=played)


def lane_launches(sessions, heads, n_layers):
    """(attention, MLP) launches of lane sessions: a prefill and a forward
    every step but the stopping one, the MTP heads every step."""
    steps = sum(s["steps"] for s in sessions)
    return n_layers * steps, n_layers * (steps - len(sessions)) + heads * steps


def start_threads(calls):
    """Each call on a thread of its own: (threads, results, errors)."""
    out, errors = [None] * len(calls), []

    def one(i):
        try:
            out[i] = calls[i]()
        except Exception as e:  # reported by join_threads
            errors.append(f"{i}: {e}")

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(calls))]
    for th in threads:
        th.start()
    return threads, out, errors


def join_threads(threads, errors, what):
    for th in threads:
        th.join(timeout=900)
    if errors or any(th.is_alive() for th in threads):
        fail(f"{what}: " + ("; ".join(errors) or "did not finish"))


def drive_streams(engine, frontend, da, mg):
    """Phase 5c: streams on the stream lane of a window-mode server and on
    the slots of a server with SLOTS slots, one reserved for streams (the
    launcher's default). Returns (results, launches)."""
    n_layers = engine.cfg.llm.backbone.num_layers
    servers = start_servers(engine, frontend, window={},
                            continuous={"continuous_slots": SLOTS, "continuous_head_num": 2,
                                        "continuous_reserve_stream": 1})
    window_url, cont_url = servers["window"][2], servers["continuous"][2]
    window_service = servers["window"][0].RequestHandlerClass.service
    service = servers["continuous"][0].RequestHandlerClass.service
    batcher = service.batcher
    results, total = [], [0, 0]

    def report(name, route, rec, pcm, chunks, tokens, segments=1):
        """One stream's record: its queue timing and each chunk's synthesis
        seconds against its audio seconds."""
        out = dict(name=name, route=route, seed=rec["seed"], samples=int(pcm.size),
                   tokens=len(tokens), chunk_synth=[(s, n / SAMPLE_RATE) for s, n in chunks],
                   **stream_timing(rec))
        if segments == 1 and pcm.size % SAMPLES_PER_TOKEN:
            fail(f"{name}: {pcm.size} samples, not a multiple of {SAMPLES_PER_TOKEN}")
        print("stream", json.dumps(out), flush=True)
        results.append(out)
        return out

    def held(name, prediction):
        launched = (da.launch_count, mg.launch_count)
        if launched != prediction or 0 in launched:
            fail(f"{name}: (attention, mlp) launches {launched}, predicted {prediction}")
        total[0] += launched[0]
        total[1] += launched[1]

    def slots_prediction(before):
        done = {k: batcher.stats[k] - before[k] for k in before}
        return (n_layers * (done["admits"] + done["forwards"]),
                n_layers * done["forwards"] + batcher.head_k * done["steps"])

    try:
        with StreamWatch(engine, [window_service, service]) as watch, \
                EngineCalls(engine) as calls:
            # first-use costs of the streaming shapes, outside the counted run
            tts_stream(window_url, "Warm up the stream.", 1)
            tts(cont_url, "Warm up the decode slots.", 2)
            tts_stream(cont_url, "Warm up the stream slots.", 2)

            # 1. the stream lane: a sentence twice on one seed, two segments
            watch.clear()
            del calls.records[:]
            da.launch_count = mg.launch_count = 0
            pcm = [tts_stream(window_url, STREAM_TEXT, STREAM_SEED) for _ in range(2)]
            two = tts_stream(window_url, STREAM_TWO, STREAM_SEED + 1)
            held("lane streams", lane_launches(watch.sessions, 2, n_layers))
            if len(watch.sessions) != 4 or calls.records or watch.slot_requests:
                fail(f"lane streams: {len(watch.sessions)} sessions, worker {calls.records}, "
                     f"{len(watch.slot_requests)} slot requests")
            if not np.array_equal(pcm[0], pcm[1]):
                diff = (np.abs(pcm[0].astype(np.int32) - pcm[1].astype(np.int32)).max()
                        if pcm[0].shape == pcm[1].shape else "shapes differ")
                fail(f"a seeded stream gave other PCM the second time: {pcm[0].size} and "
                     f"{pcm[1].size} samples, largest difference {diff}, tokens "
                     f"{'equal' if watch.sessions[0]['tokens'] == watch.sessions[1]['tokens'] else 'differ'}")
            lane_tokens = watch.sessions[0]["tokens"]
            for name, p, rec, sessions in (
                    ("lane_sentence", pcm[0], watch.streams[0], watch.sessions[:1]),
                    ("lane_sentence_again", pcm[1], watch.streams[1], watch.sessions[1:2]),
                    ("lane_two_segments", two, watch.streams[2], watch.sessions[2:])):
                report(name, "lane", rec, p, [c for s in sessions for c in s["chunks"]],
                       [t for s in sessions for t in s["tokens"]], len(sessions))

            # 2. the reserved slot: three /api/v1/tts decoding on the other
            # slots, then the lane's sentence on the same seed as a stream
            watch.clear()
            served, before = service.continuous_requests, dict(batcher.stats)
            da.launch_count = mg.launch_count = 0
            threads, _, errors = start_threads([lambda i=i: tts(cont_url, BURST[i], 2, seed=77 + i)
                                                for i in range(3)])
            deadline = time.time() + 300
            while (len(watch.slot_requests) < 3
                   or any(r.t_admit is None for r in watch.slot_requests)) \
                    and time.time() < deadline:
                time.sleep(0.005)
            utts = list(watch.slot_requests)
            reserved_free = batcher._slot_req[0] is None
            slot_pcm = tts_stream(cont_url, STREAM_TEXT, STREAM_SEED)
            join_threads(threads, errors, "the /api/v1/tts requests beside the stream")
            if len(utts) != 3 or not reserved_free:
                fail(f"reserved slot: {len(utts)} /api/v1/tts requests admitted, slot 0 "
                     f"{'free' if reserved_free else 'taken'}")
            stream_req = watch.slot_requests[3]
            held("reserved slot", slots_prediction(before))
            if service.continuous_requests - served != 4 or watch.sessions or calls.records:
                fail(f"reserved slot: continuous_requests +{service.continuous_requests - served}"
                     f", lane {len(watch.sessions)}, worker {calls.records}")

            # the stream waits at most for the chunk in flight and the
            # syntheses that run before the next admission
            def synth_span(r):
                end = r.t_submit + r.stats["latency"]
                return end - r.stats["synth_time"], end

            ahead = [r for r in utts if synth_span(r)[1] > stream_req.t_submit
                     and synth_span(r)[0] < stream_req.t_admit]
            wait_s = stream_req.t_admit - stream_req.t_submit
            bound_s = (max(r.stats["chunk_time"] for r in utts)
                       + sum(r.stats["synth_time"] for r in ahead) + 0.25)
            print("reserved slot", json.dumps(dict(
                admission_s=wait_s, bound_s=bound_s, syntheses_ahead=len(ahead),
                tts_admission_s=[r.t_admit - r.t_submit for r in utts],
                tts_decoding_at_stream_admit=sum(r.t_decoded > stream_req.t_admit
                                                 for r in utts))), flush=True)
            if wait_s > bound_s:
                fail(f"the stream waited {wait_s:.3f} s for a slot, past {bound_s:.3f} s")
            slot = report("slot_sentence", "slots", watch.streams[0], slot_pcm,
                          stream_req.stats["chunks"], stream_req.stats["tokens"])
            slot.update(admission_s=wait_s, tokens_equal_lane=stream_req.stats["tokens"]
                        == lane_tokens)
            print("slot vs lane tokens", json.dumps(dict(
                equal=slot["tokens_equal_lane"], slot=len(stream_req.stats["tokens"]),
                lane=len(lane_tokens))), flush=True)

            # 3. two concurrent streams on the slots
            watch.clear()
            served, before = service.continuous_requests, dict(batcher.stats)
            da.launch_count = mg.launch_count = 0
            threads, pair, errors = start_threads([
                lambda i=i: tts_stream(cont_url, STREAM_PAIR[i], STREAM_SEED + 10 + i)
                for i in range(2)])
            join_threads(threads, errors, "two concurrent streams")
            held("two streams", slots_prediction(before))
            if service.continuous_requests - served != 2 or watch.sessions:
                fail("two streams: not both on the slots")
            a, b = sorted(watch.slot_requests, key=lambda r: r.t_submit)
            print("two streams", json.dumps(dict(
                submitted_apart_s=b.t_submit - a.t_submit, admitted_apart_s=b.t_admit - a.t_admit,
                in_flight_together=b.t_admit < a.t_decoded)), flush=True)
            for rec in watch.streams:
                i = rec["seed"] - STREAM_SEED - 10
                (req,) = rec["reqs"]
                report(f"slot_pair_{i}", "slots", rec, pair[i], req.stats["chunks"],
                       req.stats["tokens"])

            # 4. a stream at top_p 0.5 takes the lane
            watch.clear()
            served = service.continuous_requests
            da.launch_count = mg.launch_count = 0
            other = tts_stream(cont_url, STREAM_TEXT, STREAM_SEED + 20, top_p=0.5)
            held("top_p 0.5 stream", lane_launches(watch.sessions, 2, n_layers))
            if (len(watch.sessions) != 1 or service.continuous_requests != served
                    or watch.slot_requests or calls.records):
                fail("the top_p 0.5 stream did not take the stream lane")
            report("lane_top_p", "lane", watch.streams[0], other, watch.sessions[0]["chunks"],
                   watch.sessions[0]["tokens"])
    finally:
        stop_servers(servers)

    def pct(values, q):
        return float(np.percentile(values, q)) if values else None

    summary = {}
    for route in ("lane", "slots"):
        recs = [r for r in results if r["route"] == route]
        chunk_ratio = [s / a for r in recs for s, a in r["chunk_synth"] if a > 0]
        gaps = [g for r in recs for g in r["gaps_s"]]
        summary[route] = dict(
            streams=len(recs), ttft_p50_s=pct([r["ttft_s"] for r in recs], 50),
            ttft_p95_s=pct([r["ttft_s"] for r in recs], 95), gap_p50_s=pct(gaps, 50),
            gap_p95_s=pct(gaps, 95), chunk_synth_over_audio_p50=pct(chunk_ratio, 50),
            chunk_synth_over_audio_max=max(chunk_ratio) if chunk_ratio else None,
            underruns=sum(r["underruns"] for r in recs))
    print("streaming", json.dumps(summary), flush=True)
    return dict(streams=results, summary=summary), tuple(total)


# phase 5d: zero-shot, voice conversion and the speaker registry
ZS_PROMPT_TEXT = ("This is the voice that the new sentence should borrow, recorded for a few "
                  "seconds in a quiet room.")
ZS_TEXT = ("Zero shot cloning speaks this new sentence in the borrowed voice although the "
           "speaker never read it aloud.")  # one segment: no comma past 30 characters
ZS_TWO = "The cloned voice reads this first sentence! Then it reads a second one."
ZS_LAST_PROMPT = ("The rolling prompt starts with this part! Does the second part follow it? "
                  "Yes, and the third part closes.")
ZS_PROMPTS = {"3s_16k": (16000, 3.0, 0), "10s_24k": (24000, 10.0, 1)}  # (rate, s, seed)
ZS_SEED = 777
MEL_ATOL = 1e-3  # log-mel, card (cuFFT) against the CPU
EMB_ATOL = 1e-4  # speaker embedding (values ~0.06), card against the CPU
FLIP_DISTANCE = 1e-3  # a token may flip only where its value is this near a half-integer


def voiced(sr: int, seconds: float, seed: int) -> np.ndarray:
    """A voiced harmonic prompt with a wandering f0, an amplitude envelope
    and a little noise, from a numpy seed."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(sr * seconds)) / sr
    f0 = 110 + 40 * rng.random() + 25 * np.sin(2 * np.pi * (0.3 + rng.random()) * tt)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    env = 0.5 + 0.5 * np.sin(2 * np.pi * (2 + 2 * rng.random()) * tt) ** 2
    x = sum(np.sin(k * phase + 6 * rng.random()) / k for k in range(1, 12)) * env
    x = 0.25 * x / np.abs(x).max() + 0.01 * rng.standard_normal(len(tt))
    return x.astype(np.float32)


def zero_shot_prefill_cases(heads: int = 2):
    """{prompt: (B, T, S_max, cache_len, Hq)}: the decode-attention shape of
    a zero-shot request's prefill at MAX_TOKENS, for ZS_PROMPT_TEXT + ZS_TEXT
    and each ZS_PROMPTS prompt, as the port's engine pads it: the text and
    the prompt's speech tokens (25 a second, trimmed 1:2 to the mel) each to
    a PROMPT_BUCKETS bucket, the cache to a multiple of CACHE_ROUND. Phase 5d
    holds its requests' prefills to these."""
    from flowmirror_hydravox_tpu_torch.frontend.text_norm import normalize
    from flowmirror_hydravox_tpu_torch.frontend.tokenizer import get_tokenizer
    from flowmirror_hydravox_tpu_torch.models.llm import CACHE_ROUND
    from flowmirror_hydravox_tpu_torch.runtime.engine import PROMPT_BUCKETS, _bucket

    tok = get_tokenizer()
    lt = len(tok.encode(normalize(ZS_PROMPT_TEXT))) + len(tok.encode(normalize(ZS_TEXT)))
    out = {}
    for name, (_, seconds, _) in ZS_PROMPTS.items():
        rows = 2 + _bucket(lt, PROMPT_BUCKETS) + _bucket(int(25 * seconds), PROMPT_BUCKETS)
        cap = rows + MAX_TOKENS + heads
        out[name] = (1, rows, -(-cap // CACHE_ROUND) * CACHE_ROUND, [0], 14)
    return out


# the rows of phase 5f's flash batches and phase 3's batched zero-shot cases:
# name: (mode, prompt); mode None is an SFT row (the "default" speaker)
BATCH_ROWS = {"zs_3s": ("zero_shot", "3s_16k"), "zs_10s": ("zero_shot", "10s_24k"),
              "xl_3s": ("cross_lingual", "3s_16k"), "sft": (None, None)}
ZS_BATCHES = {"B2": ("zs_3s", "sft"), "B3": ("zs_3s", "zs_10s", "sft"),
              "B4": ("zs_3s", "zs_10s", "xl_3s", "sft")}


def batched_zero_shot_cases(heads: int = 2):
    """{name: (B, T, S_max, cache_len, Hq)}: decode attention in the flash
    batches of ZS_BATCHES at MAX_TOKENS, as `Engine.synthesize_batch` pads
    them: text rows (prompt text + ZS_TEXT for zero-shot, ZS_TEXT alone for
    cross-lingual and SFT) and LM prefixes (the prompt's speech tokens for
    zero-shot, none for cross-lingual and SFT) each to the bucket of the
    longest, the cache to a multiple of CACHE_ROUND. Per batch its prefill
    (cache_len 0 in every row; the rows shorter than T are padding) and its
    first decode step (T = heads, each row's cache_len its own prompt's
    length). Phase 5f holds its burst's prefill to B3's."""
    from flowmirror_hydravox_tpu_torch.frontend.text_norm import normalize
    from flowmirror_hydravox_tpu_torch.frontend.tokenizer import get_tokenizer
    from flowmirror_hydravox_tpu_torch.models.llm import CACHE_ROUND
    from flowmirror_hydravox_tpu_torch.runtime.engine import PROMPT_BUCKETS, _bucket

    tok = get_tokenizer()
    lt_text = len(tok.encode(normalize(ZS_TEXT)))
    lt_prompt = len(tok.encode(normalize(ZS_PROMPT_TEXT)))
    rows = {}  # name: (text tokens, LM prefix tokens)
    for name, (mode, prompt) in BATCH_ROWS.items():
        zero_shot = mode == "zero_shot"
        rows[name] = (lt_text + (lt_prompt if zero_shot else 0),
                      int(25 * ZS_PROMPTS[prompt][1]) if zero_shot else 0)
    out = {}
    for batch, names in ZS_BATCHES.items():
        lts, lps = zip(*(rows[n] for n in names))
        t = 2 + _bucket(max(lts), PROMPT_BUCKETS) + (_bucket(max(lps), PROMPT_BUCKETS)
                                                     if max(lps) else 0)
        s_max = -(-(t + MAX_TOKENS + heads) // CACHE_ROUND) * CACHE_ROUND
        out[f"prefill_{batch}"] = (len(names), t, s_max, [0] * len(names), 14)
        out[f"step_{batch}"] = (len(names), heads, s_max,
                                [2 + lt + lp for lt, lp in zip(lts, lps)], 14)
    return out


def http_status(base, path, body):
    """POST `body`; (status, JSON body), error statuses included."""
    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, json.load(r)
    except urllib.error.HTTPError as e:
        return e.code, json.load(e)


def audio_of(code, body, what):
    """(samples, peak) of an audio response: 200, 24 kHz, non-empty, finite."""
    if code != 200 or not body.get("success"):
        fail(f"{what}: {code} {body.get('error')}")
    with wave.open(io.BytesIO(base64.b64decode(body["data"]["audio_base64"]))) as w:
        rate, frames = w.getframerate(), w.readframes(w.getnframes())
    pcm = np.frombuffer(frames, np.int16).astype(np.float32) / 32768.0
    if rate != SAMPLE_RATE or pcm.size == 0 or not np.isfinite(pcm).all():
        fail(f"{what}: bad WAV, rate {rate}, {pcm.size} samples")
    return pcm.size, float(np.abs(pcm).max())


class Timed:
    """While entered, adds the wall time of each call of the named methods of
    `obj` to `seconds`."""

    def __init__(self, obj, names):
        self.obj, self.names, self.seconds = obj, names, 0.0

    def __enter__(self):
        for name in self.names:
            inner = getattr(self.obj, name)

            def timed(*args, _inner=inner, **kwargs):
                t0 = time.time()
                try:
                    return _inner(*args, **kwargs)
                finally:
                    self.seconds += time.time() - t0

            setattr(self.obj, name, timed)
        return self

    def __exit__(self, *exc):
        for name in self.names:
            delattr(self.obj, name)


def check_frontend_on_card(frontend):
    """Phase 5d, part 1: the frontend on the card (TF32 off) against the same
    frontend on the CPU, for each ZS_PROMPTS prompt: tokens exact, or each
    flip printed with the CPU value's distance to its half-integer (and none
    farther than FLIP_DISTANCE); prompt mel within MEL_ATOL, embedding within
    EMB_ATOL. Then the card's tokens with cuDNN's TF32 on, as the launcher
    leaves it. Returns the per-prompt records."""
    import torch

    from flowmirror_hydravox_tpu_torch.frontend import speech_tokenizer as st
    from flowmirror_hydravox_tpu_torch.frontend.frontend import Frontend
    from flowmirror_hydravox_tpu_torch.utils.audio import resample_linear, whisper_log_mel

    cpu = Frontend(frontend.cfg, tokenizer=frontend.tokenizer, device="cpu")
    records = {}
    for name, (sr, seconds, seed) in ZS_PROMPTS.items():
        wav = voiced(sr, seconds, seed)
        frontend._prompt_features(wav, sr)  # first-use cost outside the timing
        torch.cuda.synchronize()
        t0 = time.time()
        tokens, mel = frontend._prompt_features(wav, sr)
        emb = frontend.extract_spk_embedding(wav, sr)
        card_s = time.time() - t0
        t0 = time.time()
        c_tokens, c_mel = cpu._prompt_features(wav, sr)
        c_emb = cpu.extract_spk_embedding(wav, sr)
        cpu_s = time.time() - t0
        if tokens.shape != c_tokens.shape or mel.shape != c_mel.shape:
            fail(f"frontend {name}: card shapes {tokens.shape} {mel.shape}, CPU "
                 f"{c_tokens.shape} {c_mel.shape}")
        flips = []
        if not np.array_equal(tokens, c_tokens):
            wav16 = resample_linear(torch.from_numpy(wav)[None], sr, 16000)
            wav16 = torch.nn.functional.pad(wav16, (0, -wav16.shape[-1] % 640))
            with torch.inference_mode():
                z = st.encode_fsq_values(cpu.tokenizer_params, cpu.st_cfg, whisper_log_mel(wav16))
                v = st.fsq_values(z, cpu.st_cfg.fsq_levels)[0].numpy()
            dist = np.abs(np.abs(v - np.floor(v)) - 0.5)
            for i in np.flatnonzero(tokens != c_tokens[: len(tokens)]):
                flips.append(dict(position=int(i), card=int(tokens[i]), cpu=int(c_tokens[i]),
                                  distance=float(dist[i].min())))
                print(f"frontend {name}: token {i} flips {c_tokens[i]} -> {tokens[i]}, CPU value "
                      f"{dist[i].min():.3e} from a half-integer", flush=True)
        mel_err = float(np.abs(mel - c_mel).max())
        emb_err = float(np.abs(emb - c_emb).max())
        torch.backends.cudnn.allow_tf32 = True
        try:
            tf32_tokens = frontend.extract_speech_tokens(wav, sr)
        finally:
            torch.backends.cudnn.allow_tf32 = False
        rec = dict(prompt=name, sample_rate=sr, seconds=seconds, tokens=len(tokens),
                   mel_frames=len(mel), flips=flips, mel_max_abs_err=mel_err,
                   emb_max_abs_err=emb_err, card_s=card_s, cpu_s=cpu_s,
                   tf32_token_diffs=int(np.sum(tf32_tokens[: len(tokens)] != tokens)))
        print("frontend", json.dumps(rec), flush=True)
        if any(f["distance"] > FLIP_DISTANCE for f in flips) or not (
                mel_err <= MEL_ATOL and emb_err <= EMB_ATOL):
            fail(f"frontend {name}: the card disagrees with the CPU: {rec}")
        records[name] = rec
    return records


def drive_zero_shot(engine, frontend, da, mg, prefill_cases):
    """Phase 5d: the frontend on the card against the CPU, then zero-shot,
    voice conversion and the speaker registry through a window-mode server
    and a server with SLOTS slots, every request seeded, at heads 2; each
    worker request's launches held to the prediction, voice conversion's to
    zero, the slots' from the batcher's stats; the launcher's --spk2info on
    the registry this phase saves. Returns (results, launches)."""
    from flowmirror_hydravox_tpu_torch import __main__ as launcher
    from flowmirror_hydravox_tpu_torch.utils.wavio import audio_to_base64

    cfg = engine.cfg.llm
    n_layers = cfg.backbone.num_layers
    frontend_records = check_frontend_on_card(frontend)
    b64 = {name: audio_to_base64(voiced(*spec), spec[0]) for name, spec in ZS_PROMPTS.items()}
    servers = start_servers(engine, frontend, window={},
                            continuous={"continuous_slots": SLOTS, "continuous_head_num": 2})
    window_url, cont_url = servers["window"][2], servers["continuous"][2]
    batcher = servers["continuous"][0].RequestHandlerClass.service.batcher
    fe_methods = ["frontend_zero_shot", "frontend_cross_lingual", "frontend_instruct2",
                  "frontend_vc", "add_speaker_from_audio", "extract_mel"]
    requests, total = [], [0, 0]
    vc_calls = []
    voice_convert = engine.voice_convert

    def record_vc(*args, **kwargs):
        t0 = time.time()
        out = voice_convert(*args, **kwargs)
        vc_calls.append(dict(tokens=len(args[0]), prompt_tokens=len(args[1]),
                             total_time=time.time() - t0))
        return out

    engine.voice_convert = record_vc
    slot_reqs = []
    slot_submit = batcher.submit

    def record_slot_submit(*args, **kwargs):
        req = slot_submit(*args, **kwargs)
        slot_reqs.append(req)
        return req

    batcher.submit = record_slot_submit

    def request(name, url, path, body, prompt=None, routes=None, slots=False):
        """One request; its audio checked; its launches held to the
        prediction; its record printed."""
        before = (da.launch_count, mg.launch_count, len(calls.records), len(vc_calls),
                  dict(batcher.stats), len(slot_reqs))
        t0 = time.time()
        with Timed(frontend, fe_methods) as fe_time:
            code, resp = http_status(url, path, body)
        wall = time.time() - t0
        samples, peak = audio_of(code, resp, name)
        launched = (da.launch_count - before[0], mg.launch_count - before[1])
        recs = calls.records[before[2]:]
        if slots:
            done = {k: batcher.stats[k] - before[4][k] for k in before[4]}
            predicted = (n_layers * (done["admits"] + done["forwards"]),
                         n_layers * done["forwards"] + batcher.head_k * done["steps"])
            tokens = sum(len(r.stats["tokens"]) for r in slot_reqs[before[5]:])
        else:
            predicted = predicted_launches(recs, cfg)
            tokens = sum(r["tokens"] for r in recs)
        if routes is not None and [r["route"] for r in recs] != routes:
            fail(f"{name}: engine calls {[r['route'] for r in recs]}, expected {routes}")
        if launched != predicted or (path == "/api/v1/vc") != (launched == (0, 0)):
            fail(f"{name}: (attention, mlp) launches {launched}, predicted {predicted}")
        total[0] += launched[0]
        total[1] += launched[1]
        audio_s = samples / SAMPLE_RATE
        rec = dict(name=name, path=path, prompt=prompt,
                   prompt_s=None if prompt is None else ZS_PROMPTS[prompt][1],
                   prefills=[p for r in recs for p in r.get("prefills", [])],
                   frontend_s=fe_time.seconds,
                   tokens=tokens, engine_s=sum(r["total_time"] for r in recs)
                   + sum(v["total_time"] for v in vc_calls[before[3]:]),
                   wall_s=wall, audio_s=audio_s, rtf=wall / audio_s, peak=peak,
                   attention_launches=launched[0], mlp_launches=launched[1])
        print("zero_shot", json.dumps(rec), flush=True)
        requests.append(rec)
        return rec

    def zero_shot(mode, prompt="3s_16k", text=ZS_TEXT):
        return dict(tts_text=text, prompt_text=ZS_PROMPT_TEXT, mode=mode,
                    prompt_audio_base64=b64[prompt],
                    extra_params={"inference_head_num": 2, "seed": ZS_SEED})

    try:
        with EngineCalls(engine) as calls:
            # first-use cost of the zero-shot shapes outside the counted run
            http_status(window_url, "/api/v1/zero-shot", zero_shot("zero_shot"))
            calls.records.clear()
            da.launch_count = mg.launch_count = 0
            code, body = http_status(window_url, "/api/v1/speakers/add", {
                "speaker_id": "cloned", "audio_base64": b64["3s_16k"],
                "prompt_text": ZS_PROMPT_TEXT})
            if code != 200 or body["data"] != {"speaker_id": "cloned"}:
                fail(f"/api/v1/speakers/add: {code} {body}")
            for mode in ("zero_shot", "cross_lingual", "instruct2"):
                request(f"zero_shot_{mode}", window_url, "/api/v1/zero-shot", zero_shot(mode),
                        "3s_16k", ["synthesize"])
            request("zero_shot_10s", window_url, "/api/v1/zero-shot",
                    zero_shot("zero_shot", "10s_24k"), "10s_24k", ["synthesize"])
            request("zero_shot_two_segments", window_url, "/api/v1/zero-shot",
                    zero_shot("zero_shot", text=ZS_TWO), "3s_16k", ["synthesize"] * 2)
            request("slots_zero_shot", cont_url, "/api/v1/zero-shot", zero_shot("zero_shot"),
                    "3s_16k", ["synthesize"])
            tts_body = {"text": ZS_TEXT, "speaker_id": "cloned",
                        "extra_params": {"inference_head_num": 2, "seed": ZS_SEED}}
            request("tts_cloned", window_url, "/api/v1/tts", tts_body, "3s_16k", ["synthesize"])
            request("slots_tts_cloned", cont_url, "/api/v1/tts", tts_body, "3s_16k", [],
                    slots=True)
            request("tts_last_prompt", window_url, "/api/v1/tts",
                    {"text": ZS_LAST_PROMPT, "speaker_id": "cloned", "last_prompt": True,
                     "extra_params": {"inference_head_num": 2, "seed": ZS_SEED}}, "3s_16k",
                    ["synthesize"] * 3)
            request("vc", window_url, "/api/v1/vc",
                    {"source_audio_base64": b64["3s_16k"], "prompt_audio_base64": b64["10s_24k"],
                     "extra_params": {"seed": ZS_SEED}}, "10s_24k", [])
            if len(vc_calls) != 1:
                fail(f"vc: {len(vc_calls)} Engine.voice_convert calls")

            # the registry: save, remove, the launcher on the saved file
            registry = ROOT / "chiprun_out" / "spk2info.npz"
            registry.parent.mkdir(exist_ok=True)
            default = frontend.spk2info.pop("default")
            frontend.save_spk2info(str(registry))  # the speakers this phase added
            frontend.add_speaker("default", default)
            if http_status(window_url, "/api/v1/speakers/remove/cloned", {})[0] != 200:
                fail("/api/v1/speakers/remove/cloned")
            code, body = http_status(window_url, "/api/v1/tts", tts_body)
            if code != 500 or "default" not in body["error"]:
                fail(f"/api/v1/tts on a removed speaker: {code} {body}")
            code, body = http_status(window_url, "/api/v1/zero-shot", {"tts_text": ZS_TEXT})
            if code != 400 or body["error"] != "prompt_audio_base64 required":
                fail(f"/api/v1/zero-shot without prompt audio: {code} {body}")
            _, loaded = launcher.build(launcher.parse_args(
                ["--tiny", "--device", "cuda", "--spk2info", str(registry)]))
            if loaded.available_speakers() != ["cloned"]:
                fail(f"--spk2info: speakers {loaded.available_speakers()}, saved ['cloned']")
    finally:
        del engine.voice_convert
        batcher.submit = slot_submit
        stop_servers(servers)

    # the 3 s and 10 s prompts' prefills, as the engine built them, are the
    # (T, S_max) that phase 3 timed
    for rec in requests:
        if rec["name"] in ("zero_shot_zero_shot", "zero_shot_10s", "slots_zero_shot"):
            timed = prefill_cases[rec["prompt"]][1:3]
            if rec["prefills"] != [timed]:
                fail(f"{rec['name']}: prefills (T, S_max) {rec['prefills']}, phase 3 timed "
                     f"{timed}")
    return dict(frontend=frontend_records, requests=requests,
                launcher_speakers=loaded.available_speakers()), tuple(total)

# phase 5e: the reference's .pt weights at full width
PT_SEED, PT_RELOAD_SEED = 1, 2  # the checkpoint's trees, then the hot reload's
PT_TEXT = "These weights were read from the reference checkpoint files."
RELOAD_TRIES = 3


def write_reference_checkpoints(cfg, directory, seed, names, no_stop=False):
    """Seeded full-width trees of `names` (the port's init at `cfg`, from a
    card generator seeded `seed`) written as `{name}.pt` in the reference
    key layout (HiFT's convs as weight-norm pairs), every tensor bf16 to
    halve the bytes. `no_stop` zeroes the LLM decoder's columns of the stop
    ids, so that a stop never ranks among the top-k speech tokens and a
    decode runs to its max_len (phase 5g's fallback). Returns {name: its
    state dict, on the CPU}."""
    import torch

    from flowmirror_hydravox_tpu_torch.convert import torch_import
    from flowmirror_hydravox_tpu_torch.params import (init_flow_params, init_hift_params,
                                                      init_llm_params)

    inits = {"llm": (init_llm_params, cfg.llm), "flow": (init_flow_params, cfg.flow),
             "hift": (init_hift_params, cfg.hift)}
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name in names:
        init, sub = inits[name]
        tree = init(sub, gen, "cuda", torch.bfloat16)
        if no_stop and name == "llm":
            tree["llm_decoder"][:, cfg.llm.speech_token_size:] = 0
        out[name] = {k: v.contiguous().cpu() for k, v in
                     torch_import.reference_state_dict(name, tree, cfg).items()}
        torch.save(out[name], directory / f"{name}.pt")
        del tree
    return out


def check_served_trees(engine, state_dicts):
    """Each model's live tree must equal the converter's output from its
    state dict, at the serving dtype (LLM and flow bf16, HiFT f32)."""
    import torch

    from flowmirror_hydravox_tpu_torch.convert import torch_import
    from flowmirror_hydravox_tpu_torch.params import flatten_params, from_numpy_tree

    for name, sd in state_dicts.items():
        dtype = torch.float32 if name == "hift" else torch.bfloat16
        want = flatten_params(from_numpy_tree(torch_import.convert(
            name, {k: v.float().numpy() for k, v in sd.items()}, engine.cfg), "cuda", dtype))
        live = flatten_params(getattr(engine, f"{name}_params"))
        bad = sorted(k for k in want if k not in live or not torch.equal(live[k], want[k]))
        if live.keys() != want.keys() or bad:
            fail(f"{name}: the served tree is not the converter's: {bad[:5]}")


def slots_prediction(batcher, before, n_layers):
    """((attention, MLP) launches predicted from the batcher's stats since
    `before`, the stats' differences)."""
    done = {k: batcher.stats[k] - before[k] for k in before}
    return (n_layers * (done["admits"] + done["forwards"]),
            n_layers * done["forwards"] + batcher.head_k * done["steps"]), done


def held_worker(name, calls, da, mg, cfg, run, routes, predict=None):
    """`run()` against a server's worker: its engine calls must be `routes`
    ((route, rows) pairs) and both kernels' launches the prediction from
    them (`predict`, default `predicted_launches`). Returns (records,
    launches, run's result)."""
    predict = predict or predicted_launches
    before = (da.launch_count, mg.launch_count, len(calls.records))
    try:
        out = run()
    except (RuntimeError, OSError) as e:
        fail(f"{name}: {e}")
    recs = calls.records[before[2]:]
    if [(r["route"], r["rows"]) for r in recs] != routes:
        fail(f"{name}: engine calls {[(r['route'], r['rows']) for r in recs]}, expected {routes}")
    launched = (da.launch_count - before[0], mg.launch_count - before[1])
    if launched != predict(recs, cfg) or 0 in launched:
        fail(f"{name}: (attention, mlp) launches {launched}, predicted {predict(recs, cfg)}")
    return recs, launched, out


def reload_under_load(batcher, url, path, seed0):
    """POST /api/v1/load_pt of the llm.pt at `path` to the slots server at
    `url` while SLOTS - 1 senders (seeds seed0 + i) keep its slots busy:
    repeated while the swap found every slot empty, RELOAD_TRIES times at
    most. A request must be in a slot at the swap
    (`ContinuousBatcher.between_ticks`), and every request must finish.
    Returns the reload's record."""
    import contextlib

    swaps, between = [], batcher.between_ticks

    @contextlib.contextmanager
    def watched_between():
        with between():
            swaps.append([r for r in batcher._slot_req if r is not None])
            yield

    stop, errors, sent = threading.Event(), [], [0]

    def sender(i):
        while not stop.is_set():
            try:
                tts(url, STAGGER[i], 2, seed=seed0 + i)
                sent[0] += 1
            except Exception as e:  # reported below
                errors.append(f"sender {i}: {e}")
                return

    senders = [threading.Thread(target=sender, args=(i,)) for i in range(SLOTS - 1)]
    batcher.between_ticks = watched_between
    reload_s = []
    try:
        for th in senders:
            th.start()
        time.sleep(1.0)  # the senders' first requests are in the slots by now
        while len(swaps) < RELOAD_TRIES and not (swaps and swaps[-1]):
            t0 = time.time()
            code, body = http_status(url, "/api/v1/load_pt", {"llm_pt": path})
            reload_s.append(time.time() - t0)
            if code != 200 or body["data"] != {"llm": path}:
                fail(f"/api/v1/load_pt: {code} {body}")
    finally:
        stop.set()
        for th in senders:
            th.join(timeout=900)
        batcher.between_ticks = between
    if errors or any(th.is_alive() for th in senders):
        fail("requests around the reload: " + ("; ".join(errors) or "did not finish"))
    if not swaps[-1]:
        fail(f"/api/v1/load_pt: every slot empty at each of {len(swaps)} swaps")
    if any(r.error is not None or not r.done.is_set() for r in swaps[-1]):
        fail("a request in a slot at the swap did not finish")
    return dict(reload_s=reload_s, reloads=len(swaps), in_flight_at_swap=[len(w) for w in swaps],
                requests=sent[0])


def drive_pt_weights(engine, da, mg):
    """Phase 5e: seeded full-width llm.pt / flow.pt / hift.pt in the
    reference layout, served through the launcher's `build(--model-dir)`:
    the served trees must be the converter's at the serving dtypes; one
    /api/v1/tts request on a window-mode server with launches held; then a
    server with SLOTS slots, where /api/v1/load_pt swaps in a second seed's
    llm.pt (one that never stops early) while SLOTS - 1 senders keep the
    slots busy: a request must be in a slot at the swap (the reload is
    repeated while it found none, RELOAD_TRIES in all) and every request
    must finish, and the same seeded request must decode other tokens after
    it. Last, on the reloaded weights, phase 5g's request whose estimated
    bucket is too small. Returns (record, launches)."""
    import shutil
    import tempfile

    import torch

    from flowmirror_hydravox_tpu_torch import __main__ as launcher

    cfg = engine.cfg
    n_layers = cfg.llm.backbone.num_layers
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="hydravox_pt_"))
    rec = {}
    try:
        t0 = time.time()
        sds = write_reference_checkpoints(cfg, tmp, PT_SEED, ("llm", "flow", "hift"))
        rec["write_s"] = time.time() - t0
        rec["checkpoint_bytes"] = {p.name: p.stat().st_size for p in sorted(tmp.glob("*.pt"))}
        t0 = time.time()
        pt_engine, pt_frontend = launcher.build(launcher.parse_args(
            ["--device", "cuda", "--max-tokens", str(MAX_TOKENS), "--model-dir", str(tmp)]))
        torch.cuda.synchronize()
        rec["build_s"] = time.time() - t0
        if pt_engine.cfg.llm.backbone.vocab_size != cfg.llm.backbone.vocab_size:
            fail(f"llm.pt: text vocab {pt_engine.cfg.llm.backbone.vocab_size}, the checkpoint's "
                 f"{cfg.llm.backbone.vocab_size}")
        check_served_trees(pt_engine, sds)
        del sds
        reload_dir = tmp / "reload"
        reload_dir.mkdir()
        reload_sd = write_reference_checkpoints(cfg, reload_dir, PT_RELOAD_SEED, ("llm",),
                                                no_stop=True)
        print(f"pt weights: wrote {rec['checkpoint_bytes']} in {rec['write_s']:.1f} s, built "
              f"the engine from them in {rec['build_s']:.1f} s", flush=True)
    except Exception:
        shutil.rmtree(tmp, ignore_errors=True)
        raise

    servers = start_servers(pt_engine, pt_frontend, window={},
                            slots={"continuous_slots": SLOTS, "continuous_head_num": 2})
    window_url, slots_url = servers["window"][2], servers["slots"][2]
    batcher = servers["slots"][0].RequestHandlerClass.service.batcher
    submitted, submit = [], batcher.submit

    def record_submit(*args, **kwargs):
        submitted.append(submit(*args, **kwargs))
        return submitted[-1]

    batcher.submit = record_submit
    try:
        with EngineCalls(pt_engine) as calls:
            da.launch_count = mg.launch_count = 0
            t0 = time.time()
            _, launched, (samples, _) = held_worker(
                "pt weights, /api/v1/tts", calls, da, mg, cfg.llm,
                lambda: tts(window_url, PT_TEXT, 2, seed=PT_SEED), [("synthesize", 1)])
            rec["window"] = dict(wall_s=time.time() - t0, audio_s=samples / SAMPLE_RATE,
                                 tokens=calls.records[-1]["tokens"], attention_launches=launched[0],
                                 mlp_launches=launched[1])
            total = list(launched)

            before, counts = dict(batcher.stats), (da.launch_count, mg.launch_count)
            tts(slots_url, PT_TEXT, 2, seed=PT_SEED)
            tokens_before = submitted[-1].stats["tokens"]
            reload = reload_under_load(batcher, slots_url, str(reload_dir / "llm.pt"), 2000)
            rec["reload_s"] = reload["reload_s"]
            check_served_trees(pt_engine, reload_sd)
            tts(slots_url, PT_TEXT, 2, seed=PT_SEED)
            tokens_after = submitted[-1].stats["tokens"]
            if tokens_after == tokens_before:
                fail("the same seed decoded the same tokens after the reload")
            launched = (da.launch_count - counts[0], mg.launch_count - counts[1])
            prediction, done = slots_prediction(batcher, before, n_layers)
            if calls.records[1:] or launched != prediction:
                fail(f"pt weights, slots: launches {launched}, predicted {prediction} from "
                     f"{done}; worker calls {calls.records[1:]}")
            total = [a + b for a, b in zip(total, launched)]
            # phase 5g's fallback: the reloaded LLM decodes past its estimate
            rec["solo_fallback"], more = solo_until("estimate_falls_back", window_url, SOLO_SHORT,
                                                    False, calls, da, mg, cfg.llm)
            total = [a + b for a, b in zip(total, more)]
            rec["slots"] = dict(requests=reload["requests"] + 2, reloads=reload["reloads"],
                                in_flight_at_swap=reload["in_flight_at_swap"],
                                tokens_before=len(tokens_before), tokens_after=len(tokens_after),
                                batcher_stats=done, attention_launches=launched[0],
                                mlp_launches=launched[1])
        print("pt_weights", json.dumps(rec), flush=True)
        return rec, tuple(total)
    finally:
        batcher.submit = submit
        stop_servers(servers)
        del pt_engine
        torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)


# phase 5f: zero-shot in the flash batch and on the slots
def zs_body(b64, mode, prompt, seed, **extra):
    """A /api/v1/zero-shot body: ZS_TEXT in `mode` with the ZS_PROMPTS
    prompt `prompt` (its base64 WAV in `b64`), at heads 2."""
    return dict(tts_text=ZS_TEXT, prompt_text=ZS_PROMPT_TEXT, mode=mode,
                prompt_audio_base64=b64[prompt],
                extra_params={"inference_head_num": 2, "seed": seed, **extra})


def concurrently(calls):
    """Run each () -> result of `calls` on its own thread; their results."""
    out, errors = [None] * len(calls), []

    def one(i):
        try:
            out[i] = calls[i]()
        except (Exception, SystemExit) as e:  # reported below; fail() exits
            errors.append(f"request {i}: {e}")

    threads = [threading.Thread(target=one, args=(i,)) for i in range(len(calls))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    if errors or any(th.is_alive() for th in threads):
        raise RuntimeError("; ".join(errors) or "a request did not finish")
    return out


def drive_zero_shot_batched(engine, frontend, da, mg, batch_cases):
    """Phase 5f: a zero-shot request with the 3 s prompt, one with the 10 s
    prompt and an SFT request at the zero-shot sampling, sent together to a
    server with a BURST_WINDOW window: one flash batch of 3 rows, whose
    prefill must have phase 3's B3 (T, S_max), batched_requests +3, launches
    held; each request then alone on the same seed (printed: whether its
    tokens equal its row's). Then, to a server with SLOTS slots, two plain
    zero-shot requests at the slots' sampling and a cross-lingual one:
    continuous_requests +2, the cross-lingual through the worker, launches
    held (the slots' from the batcher's stats). Returns (record, launches)."""
    from flowmirror_hydravox_tpu_torch.utils.wavio import audio_to_base64

    cfg = engine.cfg.llm
    b64 = {name: audio_to_base64(voiced(*spec), spec[0]) for name, spec in ZS_PROMPTS.items()}
    n_layers = cfg.backbone.num_layers
    servers = start_servers(engine, frontend, burst={"batch_window": BURST_WINDOW},
                            slots={"continuous_slots": SLOTS, "continuous_head_num": 2})
    burst_url, slots_url = servers["burst"][2], servers["slots"][2]
    burst_service = servers["burst"][0].RequestHandlerClass.service
    slots_service = servers["slots"][0].RequestHandlerClass.service
    batcher = slots_service.batcher
    zs_win = 32  # DEFAULT_ZS_EXTRA's win_size; the slots' sampling is the tts default, 24
    requests = {
        "zs_3s": ("/api/v1/zero-shot", zs_body(b64, "zero_shot", "3s_16k", ZS_SEED)),
        "zs_10s": ("/api/v1/zero-shot", zs_body(b64, "zero_shot", "10s_24k", ZS_SEED + 1)),
        "sft": ("/api/v1/tts", {"text": ZS_TEXT, "speaker_id": "default", "extra_params": {
            "inference_head_num": 2, "win_size": zs_win, "seed": ZS_SEED + 2}}),
    }
    rec = {}
    try:
        with EngineCalls(engine) as calls:
            da.launch_count = mg.launch_count = 0
            batched = burst_service.batched_requests
            t0 = time.time()
            recs, launched, outs = held_worker(
                "zero-shot burst", calls, da, mg, cfg,
                lambda: concurrently([lambda p=p, b=b: audio_of(*http_status(burst_url, p, b), p)
                                      for p, b in requests.values()]),
                [("synthesize_batch", 3)])
            wall = time.time() - t0
            if burst_service.batched_requests - batched != 3:
                fail(f"zero-shot burst: batched_requests rose by "
                     f"{burst_service.batched_requests - batched}")
            timed = batch_cases["prefill_B3"][1:3]
            if recs[0]["prefills"] != [timed]:
                fail(f"zero-shot burst: prefill (T, S_max) {recs[0]['prefills']}, phase 3 timed "
                     f"{timed}")
            total = list(launched)
            alone = []
            for name, (path, body) in requests.items():
                _, more, _ = held_worker(
                    f"{name} alone", calls, da, mg, cfg,
                    lambda: audio_of(*http_status(burst_url, path, body), name),
                    [("synthesize", 1)])
                total = [a + b for a, b in zip(total, more)]
                alone.append(calls.records[-1]["tokens"])
            audio_s = sum(n for n, _ in outs) / SAMPLE_RATE
            rec["flash_batch"] = dict(
                rows=list(requests), row_tokens=recs[0]["row_tokens"], alone_tokens=alone,
                rows_equal_alone=[a == b for a, b in zip(recs[0]["row_tokens"], alone)],
                prefill=recs[0]["prefills"][0], token_bucket=recs[0]["token_bucket"],
                estimated=recs[0]["estimated"], wall_s=wall, audio_s=audio_s, rtf=wall / audio_s,
                attention_launches=launched[0], mlp_launches=launched[1])

            # the two zero-shot requests together, then (so that the launch
            # counters are not bumped from two threads at once) the
            # cross-lingual one, which the worker must take
            before, counts = dict(batcher.stats), (da.launch_count, mg.launch_count)
            served, n_calls = slots_service.continuous_requests, len(calls.records)
            t0 = time.time()
            try:
                outs = concurrently([lambda b=b: audio_of(*http_status(
                    slots_url, "/api/v1/zero-shot", b), "zero-shot on a slot") for b in (
                        zs_body(b64, "zero_shot", "3s_16k", ZS_SEED, win_size=DEFAULT_WIN),
                        zs_body(b64, "zero_shot", "10s_24k", ZS_SEED + 1, win_size=DEFAULT_WIN))])
            except RuntimeError as e:
                fail(f"zero-shot on the slots: {e}")
            wall = time.time() - t0
            outs.append(audio_of(*http_status(slots_url, "/api/v1/zero-shot", zs_body(
                b64, "cross_lingual", "3s_16k", ZS_SEED + 3, win_size=DEFAULT_WIN)),
                "cross-lingual beside the slots"))
            worker = calls.records[n_calls:]
            if slots_service.continuous_requests - served != 2:
                fail(f"zero-shot on the slots: continuous_requests rose by "
                     f"{slots_service.continuous_requests - served}")
            if [(r["route"], r["rows"]) for r in worker] != [("synthesize", 1)]:
                fail(f"zero-shot on the slots: the worker served {worker}, expected the "
                     f"cross-lingual request alone")
            launched = (da.launch_count - counts[0], mg.launch_count - counts[1])
            prediction, done = slots_prediction(batcher, before, n_layers)
            prediction = tuple(a + b for a, b in zip(prediction, predicted_launches(worker, cfg)))
            if launched != prediction or done["admits"] != 2:
                fail(f"zero-shot on the slots: launches {launched}, predicted {prediction} from "
                     f"{done}")
            total = [a + b for a, b in zip(total, launched)]
            audio_s = sum(n for n, _ in outs) / SAMPLE_RATE
            rec["slots"] = dict(batcher_stats=done, worker_tokens=worker[0]["tokens"],
                                zero_shot_wall_s=wall, audio_s=audio_s,
                                attention_launches=launched[0], mlp_launches=launched[1])
        print("zero_shot_batched", json.dumps(rec), flush=True)
        return rec, tuple(total)
    finally:
        stop_servers(servers)


# phase 5g: the solo route's bucket rule
SOLO_LONG = ZS_TEXT  # its estimate (6 tokens a text token) holds on random weights
SOLO_SHORT = "Call me back."  # a few text tokens: the estimate is the 32 bucket
SOLO_SEEDS = 24  # seeds tried for each rule


def solo_until(rule, url, text, estimated, calls, da, mg, cfg):
    """Phase 5g: one-segment speed-1 requests of `text` through a window-mode
    server's `Engine.synthesize`, seeds tried in turn (SOLO_SEEDS at most)
    until one takes the bucket rule `estimated` (True: the estimated bucket
    held its tokens; False: the realised bucket). Launches held. Returns
    (record, launches)."""
    from flowmirror_hydravox_tpu_torch.runtime.engine import SYNTH_BUCKETS, _bucket

    tries, total = [], [0, 0]
    for seed in range(SOLO_SEEDS):
        recs, launched, _ = held_worker(f"{rule} seed {seed}", calls, da, mg, cfg,
                                        lambda: tts(url, text, 2, seed=seed), [("synthesize", 1)])
        total = [a + b for a, b in zip(total, launched)]
        r = recs[0]
        tries.append(dict(seed=seed, tokens=r["tokens"], token_bucket=r["token_bucket"],
                          realised_bucket=_bucket(r["tokens"], SYNTH_BUCKETS),
                          estimated=r["estimated"], total_time=r["total_time"]))
        if r["estimated"] == estimated:
            break
    else:
        fail(f"{rule}: no seed of {SOLO_SEEDS} took this rule: {tries}")
    rec = dict(rule=rule, tries=tries, **tries[-1])
    print("solo_route", json.dumps(rec), flush=True)
    return rec, tuple(total)


def drive_solo_rule(engine, frontend, da, mg):
    """Phase 5g on the main weights: a request whose estimated bucket holds
    its tokens (the other rule ran in phase 5e, on weights that do not stop
    early). Returns (record, launches)."""
    servers = start_servers(engine, frontend, window={})
    try:
        with EngineCalls(engine) as calls:
            da.launch_count = mg.launch_count = 0
            return solo_until("estimate_holds", servers["window"][2], SOLO_LONG, True, calls,
                              da, mg, engine.cfg.llm)
    finally:
        stop_servers(servers)


# phase 5h: self-speculative MTP decoding (--spec-decode) on every route
SPEC_GREEDY_TEXT = "The greedy check decodes one hundred tokens with and without drafts."
GREEDY_TOKENS = 100  # min_len = max_len: every position ignores the stop ids
GREEDY_TIE = 1e-4  # a spec token may differ only where heads=1's top two logits tie
SPEC_SOLO = {"heads2": ("Speculative heads draft the tokens that the first head checks.", 2),
             "heads5": ("With five heads, four drafts wait for every verify block.", 5)}
SPEC_SEED = 5151
# the slots draft four tokens a step: 4 slots at K 5 verify blocks of
# B 4 x T 5, and head 0 and the backbone's MLP run at M 20
SPEC_SLOT_HEADS = 5


def predicted_spec_launches(recs, cfg):
    """(attention, MLP) launches of speculative decodes (engine calls or lane
    sessions, each with its heads and steps): the prefill and one verify
    block a step, each an attention launch per layer; per step the verify
    block's MLP launch per layer, one per draft head (K - 1) and one for
    head 0 on the block; and head 0 once for the first token."""
    n_layers = cfg.backbone.num_layers
    attention = mlp = 0
    for r in recs:
        k = max(2, min(int(r["heads"]), cfg.head_num))
        attention += n_layers * (1 + r["steps"])
        mlp += n_layers * r["steps"] + k * r["steps"] + 1
    return attention, mlp


def spec_slots_prediction(batcher, before, n_layers):
    """`slots_prediction` for the slots of either kind: a spec slot's admission
    adds head 0's first token (one MLP launch), and each of its steps runs
    K heads (K - 1 drafts and head 0 on the block)."""
    (attention, mlp), done = slots_prediction(batcher, before, n_layers)
    return (attention, mlp + (done["admits"] if batcher.spec else 0)), done


class ServedShapes:
    """While active, records the shape of every launch of both kernels: the
    wrappers that the dispatchers call are swapped for ones that record and
    then call them (the launch counts stay the wrappers'). Decode attention
    by (dtype, B, T, S_max, Hq), with a copy of the cache_len of each
    forward (its layers share the tensor); the MLP by (dtype, M, H, I), its
    int8 form apart (`mlp_int8`); each with its launches. On exit each
    attention shape keeps the cache_len of the forward that read the most
    keys."""

    def __init__(self, da, mg):
        from flowmirror_hydravox_tpu_torch.ops import attention

        self._sites = ((attention, "decode_attention_cuda"), (mg, "mlp_gemv_cuda"),
                       (mg, "mlp_gemv_int8_cuda"))
        self.attention, self.mlp, self.mlp_int8 = {}, {}, {}
        self._lock = threading.Lock()

    def __enter__(self):
        (att_mod, att_name), (mlp_mod, mlp_name), (_, int8_name) = self._sites
        self._inner = inner_att, inner_mlp, inner_int8 = (
            getattr(att_mod, att_name), getattr(mlp_mod, mlp_name), getattr(mlp_mod, int8_name))

        def attention(q, k_cache, v_cache, cache_len):
            key = (str(q.dtype).replace("torch.", ""), q.shape[0], q.shape[1], k_cache.shape[1],
                   q.shape[2])
            with self._lock:
                rec = self.attention.setdefault(key, {"launches": 0, "lens": [], "last": None})
                rec["launches"] += 1
                if rec["last"] is not cache_len:
                    rec["last"] = cache_len
                    rec["lens"].append(cache_len.clone())
            return inner_att(q, k_cache, v_cache, cache_len)

        def record_mlp(shapes, x, gate):
            key = (str(x.dtype).replace("torch.", ""), x.shape[0], x.shape[1], gate.shape[1])
            with self._lock:
                shapes[key] = shapes.get(key, 0) + 1

        def mlp(x, gate, up, down):
            record_mlp(self.mlp, x, gate)
            return inner_mlp(x, gate, up, down)

        def mlp_int8(x, gate, up, down, scales):
            record_mlp(self.mlp_int8, x, gate)
            return inner_int8(x, gate, up, down, scales)

        setattr(att_mod, att_name, attention)
        setattr(mlp_mod, mlp_name, mlp)
        setattr(mlp_mod, int8_name, mlp_int8)
        return self

    def __exit__(self, *exc):
        for (mod, name), inner in zip(self._sites, self._inner):
            setattr(mod, name, inner)
        for rec in self.attention.values():
            rec["cache_len"] = max((t.tolist() for t in rec.pop("lens")), key=sum)
            del rec["last"]


def check_served_shapes(served, da, mg, flush, counted, phase="5h"):
    """5h.3 (and 5l's): every kernel shape that the phase launched
    (`ServedShapes`), at the dtype it served, against the plain version and
    timed, in the harness of phases 3 and 3b; decode attention at the
    cache_len of the forward that read the most keys. The recorded launches
    must cover the ones the phase counted (`counted`; its warm-ups add
    more). Returns {"attention": records, "mlp": records}, each record with
    its launches in the phase."""
    recorded = (sum(r["launches"] for r in served.attention.values()),
                sum(served.mlp.values()))
    if not (recorded[0] >= counted[0] > 0 and recorded[1] >= counted[1] > 0):
        fail(f"{phase}: recorded launches {recorded}, counted {counted}")
    out = {"attention": [], "mlp": []}
    for (dtype, b, t, s_max, hq), rec in sorted(served.attention.items()):
        (r,) = check_decode_attention(da, flush, [(b, t, s_max, rec["cache_len"], hq)], (dtype,))
        out["attention"].append(dict(r, **{f"launches_{phase}": rec["launches"]}))
    for (dtype, m, h, i), launches in sorted(served.mlp.items()):
        (r,) = check_mlp_gemv(mg, flush, [(m, h, i)], (dtype,))
        out["mlp"].append(dict(r, **{f"launches_{phase}": launches}))
    for name, recs in out.items():
        for r in recs:
            print(f"{phase} served shape {name}", json.dumps(r), flush=True)
    return out


def tree_to(tree, dtype):
    return {k: tree_to(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in tree.items()}


def check_spec_greedy(engine, frontend, da, mg):
    """5h.1: f32 greedy decoding (top_k 1, tau_r 2 > 1, so the repetition
    fallback never fires) of GREEDY_TOKENS tokens on the card: llm.generate at
    heads 1, then llm.generate_speculative at heads 2 and 5 on other draws.
    The spec tokens must equal heads 1's; a difference passes only where
    heads 1's two top logits (stop ids masked: every position ignores them)
    lie within GREEDY_TIE. Launches held. Returns (records, launches)."""
    import torch

    from flowmirror_hydravox_tpu_torch.models import llm as llm_model
    from flowmirror_hydravox_tpu_torch.noise import TorchNoise
    from flowmirror_hydravox_tpu_torch.ops.sampling import SamplingParams

    cfg = engine.cfg.llm
    params = tree_to(engine.llm_params, torch.float32)
    text = np.asarray(frontend.extract_text_tokens(SPEC_GREEDY_TEXT), np.int32)
    emb, plen = llm_model.build_inference_prompt(
        params, cfg, engine._tensor(text, torch.int32), len(text),
        torch.zeros(0, dtype=torch.int32, device=engine.device), 0)
    greedy = SamplingParams.make(top_p=0.5, top_k=1, win_size=10, tau_r=2.0)
    n, sts = GREEDY_TOKENS, cfg.speech_token_size
    tops, mtp_logits = [], llm_model.mtp_logits

    def recording(*args, **kwargs):
        out = mtp_logits(*args, **kwargs)
        tops.append(torch.topk(out[0, :sts], 2).values)
        return out

    def run(heads, seed):
        noise = TorchNoise(torch.Generator(engine.device).manual_seed(seed))
        before = (da.launch_count, mg.launch_count)
        t0 = time.time()
        if heads == 1:
            res = llm_model.generate(params, cfg, emb, plen, n, n, greedy, noise,
                                     inference_head_num=1, max_tokens=n)
            rec = dict(heads=1, steps=res.steps)
            predict = predicted_launches([rec], cfg)
        else:
            spec = llm_model.generate_speculative(params, cfg, emb, plen, n, n, greedy, noise,
                                                  num_heads=heads, max_tokens=n)
            res = spec.result
            rec = dict(heads=heads, steps=res.steps, accepted=spec.accepted,
                       drafted=spec.drafted, spec_acceptance=spec.accepted / max(spec.drafted, 1))
            predict = predicted_spec_launches([rec], cfg)
        tokens = res.tokens[:res.num_tokens].tolist()
        rec.update(tokens=len(tokens), wall_s=time.time() - t0)
        launched = (da.launch_count - before[0], mg.launch_count - before[1])
        if launched != predict or 0 in launched:
            fail(f"greedy heads {heads}: (attention, mlp) launches {launched}, "
                 f"predicted {predict}")
        rec.update(attention_launches=launched[0], mlp_launches=launched[1])
        return tokens, rec

    llm_model.mtp_logits = recording
    try:
        base, base_rec = run(1, 1)
    finally:
        llm_model.mtp_logits = mtp_logits
    margins = [float(a - b) for a, b in torch.stack(tops).tolist()]
    records = [base_rec]
    if len(base) != n:
        fail(f"greedy heads 1 decoded {len(base)} tokens, not {n}")
    for heads in (2, 5):
        tokens, rec = run(heads, heads)
        diff = next((i for i, (a, b) in enumerate(zip(tokens, base)) if a != b), None)
        rec.update(first_difference=diff, margin=None if diff is None else margins[diff])
        if len(tokens) != n or (diff is not None and not margins[diff] <= GREEDY_TIE):
            fail(f"greedy spec heads {heads}: {len(tokens)} tokens, first difference at "
                 f"{diff}, heads 1's top-two margin there {rec['margin']} > {GREEDY_TIE}")
        records.append(rec)
    for rec in records:
        print("spec greedy f32", json.dumps(rec), flush=True)
    del params
    torch.cuda.empty_cache()
    return records, (sum(r["attention_launches"] for r in records),
                     sum(r["mlp_launches"] for r in records))


def slots_with_stream(url, service, watch, da, mg, heads, seed0, stream_seed, what, n_layers):
    """Three /api/v1/tts senders (seeds seed0 + i) and a stream among them
    (`stream_seed`) on the slots of `service` at `heads`, watched by the
    StreamWatch `watch`: all four must ride the slots, and both kernels'
    launches (`da`, `mg`) equal the prediction from the batcher's stats.
    Returns (record, launches)."""
    batcher = service.batcher
    watch.clear()
    before, counts = dict(batcher.stats), (da.launch_count, mg.launch_count)
    served = service.continuous_requests
    t0 = time.time()
    calls = [lambda i=i: tts(url, STAGGER[i], heads, seed=seed0 + i) for i in range(3)]
    calls.insert(1, lambda: tts_stream(url, STREAM_TEXT, stream_seed, heads=heads))
    threads, out, errors = start_threads(calls)
    join_threads(threads, errors, what)
    wall = time.time() - t0
    launched = (da.launch_count - counts[0], mg.launch_count - counts[1])
    prediction, done = spec_slots_prediction(batcher, before, n_layers)
    if launched != prediction or 0 in launched:
        fail(f"{what}: launches {launched}, predicted {prediction} from {done}")
    if (service.continuous_requests - served != 4 or watch.sessions
            or len(watch.slot_requests) != 4):
        fail(f"{what}: continuous_requests +{service.continuous_requests - served}, lane "
             f"{len(watch.sessions)}, {len(watch.slot_requests)} slot requests")
    reqs = watch.slot_requests
    (stream_rec,) = watch.streams
    audio_s = (sum(o[0] for i, o in enumerate(out) if i != 1) + out[1].size) / SAMPLE_RATE
    tokens = sum(len(r.stats["tokens"]) for r in reqs)
    return dict(route="slots", requests=4, tokens=tokens, steps=done["steps"],
                tokens_per_forward=tokens / max(done["forwards"], 1),
                ms_per_step=1e3 * done["decode_s"] / max(done["steps"], 1), rtf=wall / audio_s,
                spec_acceptance=[r.stats.get("spec_acceptance", -1.0) for r in reqs],
                stream=stream_timing(stream_rec), batcher_stats=done), launched


def engine_figures(recs, audio_s, spec=False):
    """Tokens, steps, tokens per block forward, ms per decode step and RTF of
    the engine calls `recs` (EngineCalls records) that made `audio_s` s."""
    tokens, steps = sum(r["tokens"] for r in recs), sum(r["steps"] for r in recs)
    forwards = steps if spec else sum(max(r["steps"] - 1, 0) for r in recs)
    return dict(tokens=tokens, steps=steps, tokens_per_forward=tokens / max(forwards, 1),
                ms_per_step=1e3 * sum(r["llm_time"] for r in recs) / max(steps, 1),
                rtf=sum(r["total_time"] for r in recs) / audio_s,
                spec_acceptance=[r["spec_acceptance"] for r in recs])


def drive_spec(engine, frontend, da, mg):
    """Phase 5h: 5h.1 (check_spec_greedy), then, bf16, each route through a
    server on an engine built with the launcher's --spec-decode and, beside
    it, the same seeded requests through a server on the main engine: the
    solo route at heads 2 and 5, a burst of three served as one flash
    batch, a stream on the lane, and three /api/v1/tts senders with a
    stream among them on 4 slots, 1 reserved. Each WAV checked as in phase
    5; every part's launches held. Printed per route and mode: acceptance,
    tokens per block forward, ms per decode step, RTF; the streams' TTFT and
    underruns. Returns (results, launches)."""
    from flowmirror_hydravox_tpu_torch import __main__ as launcher
    from flowmirror_hydravox_tpu_torch.runtime.engine import Engine

    cfg = engine.cfg.llm
    n_layers = cfg.backbone.num_layers
    args = launcher.parse_args(["--device", "cuda", "--max-tokens", str(MAX_TOKENS),
                                "--spec-decode"])
    # the launcher's engine on the main weights, shared rather than drawn again
    spec_engine = Engine(engine.cfg, engine.llm_params, engine.flow_params, engine.hift_params,
                         max_tokens=args.max_tokens, device=engine.device,
                         spec_decode=args.spec_decode)
    greedy, launched = check_spec_greedy(engine, frontend, da, mg)
    total = list(launched)
    kinds = dict(window={}, burst={"batch_window": BURST_WINDOW},
                 slots={"continuous_slots": SLOTS, "continuous_head_num": SPEC_SLOT_HEADS,
                        "continuous_reserve_stream": 1})
    servers = {mode: start_servers(eng, frontend, **kinds)
               for mode, eng in (("spec", spec_engine), ("plain", engine))}
    results = dict(greedy_f32=greedy, routes=[])

    def add(rec, launched):
        total[0] += launched[0]
        total[1] += launched[1]
        rec.update(attention_launches=launched[0], mlp_launches=launched[1])
        print("spec route", json.dumps(rec), flush=True)
        results["routes"].append(rec)

    try:
        for mode, eng in (("spec", spec_engine), ("plain", engine)):
            spec = mode == "spec"
            srv = servers[mode]
            window_url, burst_url, slots_url = (srv[k][2] for k in ("window", "burst", "slots"))
            predict = predicted_spec_launches if spec else predicted_launches
            with EngineCalls(eng) as calls:
                tts(window_url, "Warm up the verify blocks.", 2, seed=1)
                del calls.records[:]
                # the solo route at heads 2 and 5
                for name, (text, heads) in SPEC_SOLO.items():
                    recs, launched, (samples, _) = held_worker(
                        f"5h {mode} {name}", calls, da, mg, cfg,
                        lambda: tts(window_url, text, heads, seed=SPEC_SEED), [("synthesize", 1)],
                        predict)
                    add(dict(mode=mode, route="solo", name=name, heads=heads,
                             **engine_figures(recs, samples / SAMPLE_RATE, spec)), launched)

                # a burst of three, one coalesced flash batch
                burst_service = srv["burst"][0].RequestHandlerClass.service
                batched = burst_service.batched_requests

                def burst():
                    threads, out, errors = start_threads([
                        lambda i=i: tts(burst_url, BURST[i], 2, seed=SPEC_SEED + 1 + i)
                        for i in range(len(BURST))])
                    join_threads(threads, errors, f"5h {mode} burst")
                    return out

                recs, launched, out = held_worker(f"5h {mode} flash batch", calls, da, mg, cfg,
                                                  burst, [("synthesize_batch", len(BURST))],
                                                  predict)
                if burst_service.batched_requests - batched != len(BURST):
                    fail(f"5h {mode}: the burst was not one coalesced group")
                add(dict(mode=mode, route="flash_batch", rows=len(BURST),
                         **engine_figures(recs, sum(n for n, _ in out) / SAMPLE_RATE, spec)),
                    launched)

            # a stream on the lane, then the slots with a stream among them
            slot_service = srv["slots"][0].RequestHandlerClass.service
            batcher = slot_service.batcher
            if batcher.spec != spec:
                fail(f"5h {mode}: the slots' spec_decode is {batcher.spec}")
            with StreamWatch(eng, [srv["window"][0].RequestHandlerClass.service,
                                   slot_service]) as watch:
                before = (da.launch_count, mg.launch_count)
                t0 = time.time()
                pcm = tts_stream(window_url, STREAM_TEXT, SPEC_SEED + 10)
                wall = time.time() - t0
                (session,) = watch.sessions
                sess = [dict(heads=2, steps=session["steps"])]
                prediction = (predicted_spec_launches(sess, cfg) if spec
                              else lane_launches(watch.sessions, 2, n_layers))
                launched = (da.launch_count - before[0], mg.launch_count - before[1])
                if launched != prediction or 0 in launched:
                    fail(f"5h {mode} lane stream: launches {launched}, predicted {prediction}")
                steps = session["steps"]
                forwards = steps if spec else steps - 1
                add(dict(mode=mode, route="stream_lane", tokens=len(session["tokens"]),
                         steps=steps, tokens_per_forward=len(session["tokens"]) / max(forwards, 1),
                         ms_per_step=1e3 * session["decode_s"] / max(steps, 1),
                         spec_acceptance=session.get("spec_acceptance", -1.0),
                         rtf=wall / (pcm.size / SAMPLE_RATE), **stream_timing(watch.streams[0])),
                    launched)

                tts(slots_url, "Warm up the decode slots.", SPEC_SLOT_HEADS, seed=2)
                rec, launched = slots_with_stream(slots_url, slot_service, watch, da, mg,
                                                  SPEC_SLOT_HEADS, SPEC_SEED + 20, SPEC_SEED + 10,
                                                  f"5h {mode} slots", n_layers)
                add(dict(mode=mode, **rec), launched)
    finally:
        for srv in servers.values():
            stop_servers(srv)
    return results, tuple(total)


# phase 5i: weight-only int8 (--quantize int8)
INT8_SOLO = {"heads1": ("Integer weights speak this sentence with a single head.", 1),
             "heads2": ("Integer weights speak this sentence two tokens at a time.", 2),
             "heads5": ("With five heads the integer weights decode this sentence.", 5)}
INT8_SEED = 6161
INT8_EVAL = dict(utterances=2, tokens=100)  # tools/eval_int8.py on the main weights


class Int8Form:
    """Kernel 2's int8 form under the name of the bf16 form's counter, so
    that the launch helpers of phases 5-5h hold its launches."""

    def __init__(self, mg):
        self._mg = mg

    @property
    def launch_count(self):
        return self._mg.int8_launch_count

    @launch_count.setter
    def launch_count(self, value):
        self._mg.int8_launch_count = value


def mlp_int8_bound(m: int, h: int, i: int, dtype) -> tuple:
    """(bound_ms, bound_by) of the int8 form: bytes (x and the output in x's
    type, the three int8 weights and their f32 scales, each once) over the
    HBM rate vs operations (as `mlp_bound`) over the peak of x's type, in
    which the weights are multiplied."""
    nbytes = 2 * m * h * dtype.itemsize + 3 * h * i + 4 * (2 * i + h)
    flops = 6 * m * h * i + 4 * m * i
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).replace("torch.", "")]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check_mlp_gemv_int8(mg, flush, cases, dtypes=("bfloat16",)):
    """Kernel 2's int8 form at each case (M, H, I) and dtype of x against
    its plain version, twice (the two calls must be bit-equal), timed as in
    phase 3b, beside the dense form of the kernel on the dequantized weights
    (`dense_kernel_ms`, in x's dtype) and the matmul_q-form yardstick: three
    products on the dequantized weights and the two elementwise ops
    (`library_ms`), and the share of its bound it reaches (`bound_share`,
    bound_ms / kernel_ms). Returns the per-case records."""
    import torch
    import torch.nn.functional as F

    from flowmirror_hydravox_tpu_torch.ops import quant

    g = torch.Generator(device="cuda").manual_seed(3)
    records = []
    for dtype in (getattr(torch, d) for d in dtypes):
        for m, h, i in cases:
            x = torch.randn(m, h, generator=g, device="cuda").to(dtype)
            pairs = [quant.quantize_weight_int8(
                torch.randn(shape, generator=g, device="cuda") * 0.05)
                for shape in ((h, i), (h, i), (i, h))]
            weights, scales = [w for w, _ in pairs], tuple(sc for _, sc in pairs)
            dense = [(w.float() * sc).to(dtype) for w, sc in pairs]
            what = f"mlp_gemv_int8 {dtype} M{m} H{h} I{i}"
            out = mg.mlp_gemv_int8_cuda(x, *weights, scales)
            torch.cuda.synchronize()
            ref = mg.mlp_gemv_ref(x, *weights, scales).float()
            err = (out.float() - ref).abs().max().item()
            lim = TOL[str(dtype).replace("torch.", "")] * (1.0 + ref.abs().max().item())
            if not err <= lim:
                fail(f"{what}: err {err} > {lim}")
            if not torch.equal(mg.mlp_gemv_int8_cuda(x, *weights, scales), out):
                fail(f"{what}: two calls differ")
            rec = dict(
                dtype=str(dtype).replace("torch.", ""), M=m, H=h, I=i, max_abs_err=err,
                kernel_ms=time_ms(lambda: mg.mlp_gemv_int8_cuda(x, *weights, scales), flush),
                ref_ms=time_ms(lambda: mg.mlp_gemv_ref(x, *weights, scales), flush),
                dense_kernel_ms=time_ms(lambda: mg.mlp_gemv_cuda(x, *dense), flush),
                library_ms=time_ms(lambda: (F.silu(x @ dense[0]) * (x @ dense[1])) @ dense[2],
                                   flush),
            )
            rec["library_ratio"] = rec["kernel_ms"] / rec["library_ms"]
            rec["dense_ratio"] = rec["kernel_ms"] / rec["dense_kernel_ms"]
            rec["bound_ms"], rec["bound_by"] = mlp_int8_bound(m, h, i, dtype)
            rec["bound_share"] = rec["bound_ms"] / rec["kernel_ms"]
            if dtype == torch.bfloat16:  # the one-launch form's plan
                rec["plan"] = mg.plan_int8(m, h, i, mg._resident)._asdict()
            records.append(rec)
            print("mlp_gemv_int8", json.dumps(rec), flush=True)
    return records


def check_int8_shapes(served, mg, flush, counted):
    """5i's shape check: every shape of the int8 form that phase 5i launched
    (`ServedShapes.mlp_int8`), at the dtype it served, in
    `check_mlp_gemv_int8`. The recorded launches must cover the ones the
    phase counted. Returns the records, each with its launches in 5i."""
    recorded = sum(served.mlp_int8.values())
    if not recorded >= counted > 0:
        fail(f"5i: recorded launches of the int8 form {recorded}, counted {counted}")
    out = []
    for (dtype, m, h, i), launches in sorted(served.mlp_int8.items()):
        (r,) = check_mlp_gemv_int8(mg, flush, [(m, h, i)], (dtype,))
        out.append(dict(r, launches_5i=launches))
        print("5i served shape mlp_int8", json.dumps(out[-1]), flush=True)
    # clusters of the one-launch form that fit at once (row groups, H, shared
    # memory, cluster size), as the plans read them
    print("int8 resident clusters", json.dumps(
        {",".join(map(str, key)): n for key, n in sorted(mg._resident_counts.items())}),
        flush=True)
    return out


def load_parent_mlp_gemv(root: pathlib.Path):
    """An earlier tree's ops/mlp_gemv.py, loaded as package
    `ab_parent_port`: it builds that tree's csrc/mlp_gemv.cu into that
    tree's build/."""
    import importlib
    import importlib.util

    name = "ab_parent_port"
    pkg = root / "flowmirror_hydravox_tpu_torch"
    if not (pkg / "csrc" / "mlp_gemv.cu").is_file():
        fail(f"--ab-parent: no port package under {root}")
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{name}.ops.mlp_gemv")


def compare_int8_forms(parent, shapes) -> list:
    """Kernel 2's int8 form of an earlier tree (`parent`, its ops/mlp_gemv
    module) and of this tree at each (M, H, I), bf16 rows, seeded int8
    weights: each held to this tree's plain version, then timed as phase 3b
    times kernels, in the order earlier, this, this, earlier."""
    import torch

    from flowmirror_hydravox_tpu_torch.ops import mlp_gemv as mg
    from flowmirror_hydravox_tpu_torch.ops import quant

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    g = torch.Generator(device="cuda").manual_seed(17)
    forms = {"parent": parent, "new": mg}
    records = []
    for m, h, i in shapes:
        x = torch.randn(m, h, generator=g, device="cuda").to(torch.bfloat16)
        pairs = [quant.quantize_weight_int8(torch.randn(shape, generator=g, device="cuda") * 0.05)
                 for shape in ((h, i), (h, i), (i, h))]
        weights, scales = [w for w, _ in pairs], tuple(sc for _, sc in pairs)
        ref = mg.mlp_gemv_ref(x, *weights, scales).float()
        lim = TOL["bfloat16"] * (1.0 + ref.abs().max().item())
        rec = dict(M=m, H=h, I=i, bound_ms=mlp_int8_bound(m, h, i, torch.bfloat16)[0])
        for key, mod in forms.items():
            out = mod.mlp_gemv_int8_cuda(x, *weights, scales)
            torch.cuda.synchronize()
            err = (out.float() - ref).abs().max().item()
            if not err <= lim:
                fail(f"ab {key} form M{m} H{h} I{i}: err {err} > {lim}")
            rec[f"{key}_max_abs_err"] = err
        turns = ("parent", "new", "new", "parent")
        times = [time_ms(lambda mod=forms[k]: mod.mlp_gemv_int8_cuda(x, *weights, scales), flush)
                 for k in turns]
        for key in forms:
            rec[f"{key}_ms"] = [t for k, t in zip(turns, times) if k == key]
            rec[f"{key}_bound_share"] = rec["bound_ms"] / min(rec[f"{key}_ms"])
        rec["speedup"] = min(rec["parent_ms"]) / min(rec["new_ms"])
        records.append(rec)
        print("ab mlp_gemv_int8", json.dumps(rec), flush=True)
    return records


# bf16 shapes of the int8 form timed in turns besides 5i's: the rows past
# one 8-row group that the slots' verify block (20) and the flash batches
# (9, 40, 65) give at I 4864 and the slots' head 0 at the MTP width, as
# tests/test_torch_kernels_int8.py's CARD_CASES hold them; Qwen2-1.5B's
# 1536 x 8960 at 8 and 16 rows a block
AB_SHAPES = [(9, 896, 4864), (20, 896, 4864), (40, 896, 4864), (65, 896, 4864),
             (20, 896, 22016), (2, 1536, 8960), (20, 1536, 8960)]


def ab_main(argv):
    """--ab-parent DIR: the int8 forms in turns."""
    import argparse

    p = argparse.ArgumentParser(prog="chip_smoke.py")
    p.add_argument("--ab-parent", required=True, type=pathlib.Path)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA GPU")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    card = census()
    served = json.loads((ROOT / "chiprun_out" / "chip_smoke.json").read_text())
    shapes = sorted({(k["M"], k["H"], k["I"]) for k in served["int8"]["kernels"]
                     if k["dtype"] == "bfloat16"} | set(AB_SHAPES))
    records = compare_int8_forms(load_parent_mlp_gemv(args.ab_parent.resolve()), shapes)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "ab_mlp_int8.json").write_text(
        json.dumps({"card": card, "records": records}, indent=1))
    print(card, flush=True)


def check_int8_tree(params, what):
    """Every matrix that ops/quant.py quantizes must be int8 beside its f32
    scale."""
    import torch

    from flowmirror_hydravox_tpu_torch.ops import quant

    groups = ((params["backbone"]["layers"], quant.QWEN2_LAYER_MATS),
              (params["mtp_block"], quant.MTP_HEAD_MATS), (params, ("llm_decoder",)))
    bad = [n for leaves, names in groups for n in names
           if leaves[n].dtype != torch.int8
           or getattr(leaves.get(n + quant.SCALE_SUFFIX), "dtype", None) != torch.float32]
    if bad:
        fail(f"{what}: not int8 with scales: {bad}")


def drive_int8(engine, frontend, da, mg):
    """Phase 5i: an engine built as the launcher's --quantize int8 builds it,
    on the main (seed-0 bf16) weights, behind servers: /api/v1/tts on the
    solo route at heads 1, 2 and 5, a burst of three coalesced into one
    flash batch, a /api/v1/tts/stream on the lane, three /api/v1/tts with a
    stream among them on 4 slots (1 reserved), and one request at heads 2 on
    an int8 engine with --spec-decode. Each WAV as in phase 5; every route's
    launches held to the prediction (decode attention; kernel 2's int8 form
    in place of its dense form, which must not launch at all). Beside them,
    the same seeded solo heads-2 request and slot load on the main engine
    (ms per decode step, int8 against bf16). Last, phase 5e's llm.pt (seed
    1) is hot-reloaded into the int8 slots while 3 senders keep them busy:
    the live tree must be that checkpoint's, quantized. Returns (results,
    launches (attention, dense MLP, int8 MLP), the int8 tree the routes
    served)."""
    import shutil
    import tempfile

    import torch

    from flowmirror_hydravox_tpu_torch import __main__ as launcher
    from flowmirror_hydravox_tpu_torch.convert import torch_import
    from flowmirror_hydravox_tpu_torch.ops import quant
    from flowmirror_hydravox_tpu_torch.params import flatten_params, from_numpy_tree
    from flowmirror_hydravox_tpu_torch.runtime.engine import Engine

    cfg = engine.cfg.llm
    n_layers = cfg.backbone.num_layers
    int8c = Int8Form(mg)
    args = launcher.parse_args(["--device", "cuda", "--max-tokens", str(MAX_TOKENS),
                                "--quantize", "int8"])
    t0 = time.time()
    # the launcher's engine on the main weights, not drawn again; the spec
    # engine shares its int8 tree (quantize_llm_params leaves int8 as it is)
    q_engine = Engine(engine.cfg, engine.llm_params, engine.flow_params, engine.hift_params,
                      max_tokens=args.max_tokens, device=engine.device, quantize=args.quantize)
    spec_engine = Engine(engine.cfg, q_engine.llm_params, engine.flow_params, engine.hift_params,
                         max_tokens=args.max_tokens, device=engine.device,
                         quantize=args.quantize, spec_decode=True)
    torch.cuda.synchronize()
    int8_tree = q_engine.llm_params
    check_int8_tree(int8_tree, "the int8 engine")
    dense_bytes = quant.tree_bytes(engine.llm_params)[0]
    int8_bytes, int8_leaf_bytes = quant.tree_bytes(int8_tree)
    results = dict(build_s=time.time() - t0, routes=[], bf16_beside=[],
                   llm_bytes={"bf16": dense_bytes, "int8": int8_bytes,
                              "int8_leaves": int8_leaf_bytes})
    print(f"int8: engines built in {results['build_s']:.1f} s; LLM weight bytes bf16 "
          f"{dense_bytes}, int8 {int8_bytes} ({int8_leaf_bytes} of them int8)", flush=True)

    slot_kwargs = {"continuous_slots": SLOTS, "continuous_head_num": 2,
                   "continuous_reserve_stream": 1}
    servers = start_servers(q_engine, frontend, window={}, burst={"batch_window": BURST_WINDOW},
                            slots=slot_kwargs)
    spec_servers = start_servers(spec_engine, frontend, window={})
    dense_servers = start_servers(engine, frontend, window={}, slots=slot_kwargs)
    window_url, burst_url, slots_url = (servers[k][2] for k in ("window", "burst", "slots"))
    spec_url = spec_servers["window"][2]
    slot_service = servers["slots"][0].RequestHandlerClass.service
    batcher = slot_service.batcher
    total, dense_total = [0, 0], [0, 0]  # (attention, int8 MLP); (attention, dense MLP)

    def add(key, rec, launched, counts):
        counts[0] += launched[0]
        counts[1] += launched[1]
        rec.update(attention_launches=launched[0], mlp_launches=launched[1])
        print(f"int8 {key}", json.dumps(rec), flush=True)
        results[key].append(rec)

    try:
        # first use of each server's route and of the int8 form, uncounted
        for url in (window_url, spec_url, slots_url, *(v[2] for v in dense_servers.values())):
            tts(url, "Warm up the integer weights.", 2, seed=1)
        with StreamWatch(q_engine, [servers["window"][0].RequestHandlerClass.service,
                                    slot_service]) as watch:
            # the counts from here are 5i's int8 routes'
            da.launch_count = mg.launch_count = mg.int8_launch_count = 0
            with EngineCalls(q_engine) as calls:
                for name, (text, heads) in INT8_SOLO.items():
                    recs, launched, (samples, _) = held_worker(
                        f"5i {name}", calls, da, int8c, cfg,
                        lambda: tts(window_url, text, heads, seed=INT8_SEED), [("synthesize", 1)])
                    add("routes", dict(route="solo", name=name, heads=heads,
                                       **engine_figures(recs, samples / SAMPLE_RATE)),
                        launched, total)
                burst_service = servers["burst"][0].RequestHandlerClass.service
                batched = burst_service.batched_requests

                def burst():
                    threads, out, errors = start_threads([
                        lambda i=i: tts(burst_url, BURST[i], 2, seed=INT8_SEED + 1 + i)
                        for i in range(len(BURST))])
                    join_threads(threads, errors, "5i burst")
                    return out

                recs, launched, out = held_worker("5i flash batch", calls, da, int8c, cfg, burst,
                                                  [("synthesize_batch", len(BURST))])
                if burst_service.batched_requests - batched != len(BURST):
                    fail("5i: the burst was not one coalesced group")
                add("routes", dict(route="flash_batch", rows=len(BURST), **engine_figures(
                    recs, sum(n for n, _ in out) / SAMPLE_RATE)), launched, total)

            before = (da.launch_count, int8c.launch_count)
            t0 = time.time()
            pcm = tts_stream(window_url, STREAM_TEXT, INT8_SEED + 10)
            wall = time.time() - t0
            (session,) = watch.sessions
            prediction = lane_launches(watch.sessions, 2, n_layers)
            launched = (da.launch_count - before[0], int8c.launch_count - before[1])
            if launched != prediction or 0 in launched:
                fail(f"5i lane stream: launches {launched}, predicted {prediction}")
            add("routes", dict(route="stream_lane", tokens=len(session["tokens"]),
                               steps=session["steps"],
                               ms_per_step=1e3 * session["decode_s"] / max(session["steps"], 1),
                               rtf=wall / (pcm.size / SAMPLE_RATE),
                               **stream_timing(watch.streams[0])), launched, total)
            rec, launched = slots_with_stream(slots_url, slot_service, watch, da, int8c, 2,
                                              INT8_SEED + 20, INT8_SEED + 10, "5i slots",
                                              n_layers)
            add("routes", rec, launched, total)
        with EngineCalls(spec_engine) as calls:
            recs, launched, (samples, _) = held_worker(
                "5i spec heads2", calls, da, int8c, cfg,
                lambda: tts(spec_url, SPEC_SOLO["heads2"][0], 2, seed=INT8_SEED),
                [("synthesize", 1)], predicted_spec_launches)
            add("routes", dict(route="spec_solo", heads=2, **engine_figures(
                recs, samples / SAMPLE_RATE, spec=True)), launched, total)
        counted = (da.launch_count, mg.int8_launch_count)
        if counted != tuple(total) or mg.launch_count != 0 or 0 in counted:
            fail(f"5i: (attention, int8 MLP) launches {counted}, the routes' {total}; the "
                 f"dense MLP form launched {mg.launch_count} times")

        # the same seeded solo request and slot load on the main (bf16) engine
        dense_slot_service = dense_servers["slots"][0].RequestHandlerClass.service
        with EngineCalls(engine) as calls:
            text, heads = INT8_SOLO["heads2"]
            recs, launched, (samples, _) = held_worker(
                "5i bf16 heads2", calls, da, mg, cfg,
                lambda: tts(dense_servers["window"][2], text, heads, seed=INT8_SEED),
                [("synthesize", 1)])
            add("bf16_beside", dict(route="solo", name="heads2", heads=heads,
                                    **engine_figures(recs, samples / SAMPLE_RATE)),
                launched, dense_total)
        with StreamWatch(engine, [dense_slot_service]) as watch:
            rec, launched = slots_with_stream(dense_servers["slots"][2], dense_slot_service, watch,
                                              da, mg, 2, INT8_SEED + 20, INT8_SEED + 10,
                                              "5i bf16 slots", n_layers)
            add("bf16_beside", rec, launched, dense_total)

        # phase 5e's llm.pt hot-reloaded into the busy int8 slots
        tmp = pathlib.Path(tempfile.mkdtemp(prefix="hydravox_int8_"))
        try:
            sd = write_reference_checkpoints(engine.cfg, tmp, PT_SEED, ("llm",))["llm"]
            before, counts = dict(batcher.stats), (da.launch_count, int8c.launch_count)
            reload = reload_under_load(batcher, slots_url, str(tmp / "llm.pt"), 4000)
            launched = (da.launch_count - counts[0], int8c.launch_count - counts[1])
            prediction, done = slots_prediction(batcher, before, n_layers)
            if launched != prediction or mg.launch_count != dense_total[1]:
                fail(f"5i reload: launches {launched}, predicted {prediction} from {done}")
            check_int8_tree(q_engine.llm_params, "the int8 engine after /api/v1/load_pt")
            want = flatten_params(quant.quantize_llm_params(from_numpy_tree(torch_import.convert(
                "llm", {k: v.float().numpy() for k, v in sd.items()}, engine.cfg), "cuda",
                torch.bfloat16)))
            live = flatten_params(q_engine.llm_params)
            bad = sorted(k for k in want if k not in live or not torch.equal(live[k], want[k]))
            if live.keys() != want.keys() or bad:
                fail(f"5i reload: the live tree is not llm.pt's, quantized: {bad[:5]}")
            total[0] += launched[0]
            total[1] += launched[1]
            results["reload"] = dict(reload, batcher_stats=done, attention_launches=launched[0],
                                     mlp_launches=launched[1])
            print("int8 reload", json.dumps(results["reload"]), flush=True)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    finally:
        for srv in (servers, spec_servers, dense_servers):
            stop_servers(srv)
    del q_engine, spec_engine
    torch.cuda.empty_cache()
    solo = [r["ms_per_step"] for r in results["routes"] + results["bf16_beside"]
            if r["route"] == "solo" and r["heads"] == 2]
    slots = [r["ms_per_step"] for r in results["routes"] + results["bf16_beside"]
             if r["route"] == "slots"]
    print(f"5i ms per decode step, int8 against bf16: solo heads 2 {solo[0]:.3f} / "
          f"{solo[1]:.3f}, slots {slots[0]:.3f} / {slots[1]:.3f}", flush=True)
    return results, (total[0] + dense_total[0], dense_total[1], total[1]), int8_tree


# phase 5j: training on the card
TRAIN_SEED = 31
TRAIN_LLM = (16, 64, 256)  # B, text bucket, speech bucket: tools/bench_train.py's first point
TRAIN_FLOW = (16, 128)  # B, token bucket (256 mel frames)
TRAIN_STEPS = 12
TRAIN_TIMED = slice(2, None)  # steps 3-12
FIXED_STEPS = 30  # the fixed-batch learning checks, constant learning rate
FIXED_CODES = 64  # speech codes of the fixed LLM batch and of the flow's mel templates
TRAIN_LR = 1e-4
# the card-vs-CPU step: Adam's first step moves every element with a non-zero
# gradient by up to +-lr, and an element whose gradient lies within the two
# devices' rounding of zero may move the other way on the other device: at
# 1e-5 that is inside 1e-4 x (1 + |p|); the gradients themselves are held
# through Adam's first moment (mu = 0.1 g) within 1e-4 of each leaf's largest
CROSS_LR = 1e-5
CROSS_TOL = 1e-4
# the MTP heads' q/k projections: kept for the checkpoint layout, never
# multiplied (the reduced length-1 head), so no gradient reaches them, in JAX
# as here
MTP_DEAD = tuple(f"mtp_block.{p}_proj_{w}" for p in "qk" for w in "wb")
RESUME_AT = 4  # the train state saved after this step, resumed into a fresh loop
RESUME_TOL = 2e-2  # bf16, and the embedding backward's atomics are not bit-stable
TRAIN_TEXT = "These weights were trained on the card a moment ago."
TRAIN_WORDS = ("speech model token voice sound train step card batch loss weight layer head "
               "text audio frame learn rate norm clip decay stream slot noise flow mel wave "
               "pitch sample chunk cache query key value gate down up").split()


class DrawsOn:
    """A flow-loss and vocoder noise source that draws on the CPU from `seed`
    and hands the draws over on `device`, so that two devices train on the
    same numbers."""

    def __init__(self, seed, device):
        import torch

        from flowmirror_hydravox_tpu_torch.noise import TorchNoise

        self.source = TorchNoise(torch.Generator().manual_seed(seed))
        self.device = device

    def vocoder(self, *args):
        return tuple(x.to(self.device) for x in self.source.vocoder(*args))

    def flow_loss(self, *args):
        d = self.source.flow_loss(*args)
        keep = None if d.keep is None else [tuple(m.to(self.device) for m in pair)
                                            for pair in d.keep]
        return type(d)(*(x.to(self.device) for x in d[:5]), keep)

    def split(self, k):
        return [self] * k


def llm_rows(rng, n_rows, llm_cfg, tokens=None, text_words=(34, 44), speech_len=(200, 257)):
    """Seeded LLM rows: English texts of `text_words` words (the
    whisper-tiktoken tokenizer makes 35-45 tokens of them) and speech
    tokens from `tokens` (default every code), `speech_len` long."""
    codes = np.arange(llm_cfg.speech_token_size) if tokens is None else tokens
    return [{"text": " ".join(rng.choice(TRAIN_WORDS, int(rng.integers(*text_words)))) + ".",
             "speech_token": rng.choice(codes, int(rng.integers(*speech_len))).tolist()}
            for _ in range(n_rows)]


def flow_rows(rng, n_rows, flow_cfg, templates=None, token_len=(100, 129)):
    """Seeded flow rows of 100-128 tokens: the mel a fixed (2, 80) template
    per code plus noise of 0.1 when `templates` (codes, 2, 80) is given (the
    codes then from its rows), else standard normal; a random embedding."""
    rows = []
    for _ in range(n_rows):
        n = int(rng.integers(*token_len))
        if templates is None:
            toks = rng.integers(0, flow_cfg.vocab_size, n)
            mel = rng.standard_normal((2 * n, 80))
        else:
            toks = rng.integers(0, len(templates), n)
            mel = templates[toks].reshape(2 * n, 80) + 0.1 * rng.standard_normal((2 * n, 80))
        rows.append({"speech_token": toks.tolist(), "mel": mel.astype(np.float32),
                     "embedding": rng.standard_normal(192).astype(np.float32)})
    return rows


def collated(collator, rows, batch, shapes):
    """Batches of `batch` rows, each checked to have `shapes` ({key: shape})."""
    out = [collator(rows[i:i + batch]) for i in range(0, len(rows), batch)]
    for b in out:
        for k, shape in shapes.items():
            if b[k].shape != shape:
                fail(f"5j: collated {k} {b[k].shape}, expected {shape}")
    return out


def leaf_err(a, b):
    """max |a - b| / (1 + |b|) over every element of two trees' leaves."""
    from flowmirror_hydravox_tpu_torch.train.steps import tree_leaves

    return max(float(((x.detach().cpu() - y.detach()).abs() / (1 + y.detach().abs())).max())
               for (_, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)))


def grad_err(opt_a, opt_b):
    """Largest over leaves of max |mu_a - mu_b| / max |mu_b| (Adam's first
    moment after one step is 0.1 x the gradient)."""
    out = 0.0
    for k, mb in opt_b["mu"].items():
        scale = float(mb.abs().max())
        if scale > 0:
            out = max(out, float((opt_a["mu"][k].cpu() - mb).abs().max()) / scale)
    return out


def tree_to_device(tree, dev):
    """A copy of `tree` on `dev`."""
    from flowmirror_hydravox_tpu_torch.params import flatten_params, unflatten_params

    return unflatten_params({k: v.to(dev, copy=True) for k, v in flatten_params(tree).items()})


def train_cross_device(cfg, tokenizer, dev):
    """5j.1: one llm_train_step and one flow_train_step at f32 on the card and
    on the CPU from the same weights, batch and draws: the full-width LLM at 2
    layers and 2 MTP heads, the DiT at 2 blocks. Loss and grad norm within
    CROSS_TOL relative, params within CROSS_TOL x (1 + |p|), Adam's first
    moments (the gradients) within CROSS_TOL of each leaf's largest. `dev`
    is the card (a CPU rehearsal passes the CPU)."""
    import dataclasses

    import torch

    from flowmirror_hydravox_tpu_torch.params import init_flow_params, init_llm_params
    from flowmirror_hydravox_tpu_torch.train import data, steps

    rng = np.random.default_rng(TRAIN_SEED)
    llm_cfg = dataclasses.replace(cfg.llm, head_num=2, backbone=dataclasses.replace(
        cfg.llm.backbone, num_layers=2))
    est = dataclasses.replace(cfg.flow.estimator, depth=2)
    flow_cfg = dataclasses.replace(cfg.flow, estimator=est)
    llm_batch = data.LLMCollator(tokenizer)(llm_rows(rng, 2, llm_cfg, speech_len=(100, 129)))
    flow_batch = data.FlowCollator()(flow_rows(rng, 2, flow_cfg, token_len=(50, 65)))
    out = {}
    for name, init, sub, batch, run in (
            ("llm", init_llm_params, llm_cfg, llm_batch,
             lambda st, b, dev, c, o: steps.llm_train_step(st, b, c, o)),
            ("flow", init_flow_params, flow_cfg, flow_batch,
             lambda st, b, dev, c, o: steps.flow_train_step(st, b, DrawsOn(TRAIN_SEED, dev), c, o))):
        opt = steps.Optimizer(steps.OptimConfig(learning_rate=CROSS_LR, schedule="constant"))
        cpu_params = init(sub, torch.Generator().manual_seed(TRAIN_SEED), "cpu", torch.float32)
        card = steps.init_state(tree_to_device(cpu_params, dev), opt)
        cpu = steps.init_state(cpu_params, opt)
        card, m_card = run(card, steps.batch_to(batch, dev), dev, sub, opt)
        cpu, m_cpu = run(cpu, steps.batch_to(batch, "cpu"), "cpu", sub, opt)
        rec = {f"{k}_rel": abs(float(m_card[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
               for k in ("loss", "grad_norm")}
        rec.update(loss=float(m_card["loss"]), params_err=leaf_err(card.params, cpu.params),
                   grad_err=grad_err(card.opt_state, cpu.opt_state),
                   batch={k: list(v.shape) for k, v in batch.items()})
        print(f"5j card vs CPU {name}", json.dumps(rec), flush=True)
        if max(rec["loss_rel"], rec["grad_norm_rel"], rec["params_err"],
               rec["grad_err"]) > CROSS_TOL:
            fail(f"5j: the card's {name} train step differs from the CPU's: {rec}")
        out[name] = rec
        del card, cpu, cpu_params
    return out


class StepLog:
    """A trainer loop's `on_step`: synchronises the card, records each step's
    wall time, loss and grad norm, fails on a non-finite one, and after step
    1 requires a finite, non-zero first moment (a gradient) on every leaf
    but `frozen`, and none on `frozen`. After step `moments_at` it records
    the optimizer's count and the global norms of its two moments."""

    def __init__(self, what, dev, frozen=(), moments_at=None):
        self.what, self.dev, self.frozen = what, dev, frozen
        self.moments_at, self.moments = moments_at, None
        self.losses, self.gnorms, self.secs, self.metrics = [], [], [], []
        self.t = time.perf_counter()

    def __call__(self, state, metrics):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.secs.append(now - self.t)
        self.t = now
        loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
        if not (np.isfinite(loss) and np.isfinite(gnorm)):
            fail(f"5j {self.what}: step {state.step} loss {loss} grad norm {gnorm}")
        self.losses.append(loss)
        self.gnorms.append(gnorm)
        self.metrics.append({k: float(v) for k, v in metrics.items()})
        if state.step == 1:
            for k, mu in state.opt_state["mu"].items():
                trained = bool(mu.abs().max() > 0) and bool(torch.isfinite(mu).all())
                if trained == (k in self.frozen):
                    fail(f"5j {self.what}: leaf {k} {'got' if trained else 'got no'} gradient "
                         f"in step 1")
        if state.step == self.moments_at:
            opt = state.opt_state
            self.moments = dict(count=int(opt["count"]), **{
                name: float(sum(torch.sum(t.float() ** 2) for t in opt[name].values()) ** 0.5)
                for name in ("mu", "nu")})


def reset_peak(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def train_figures(log, tokens, matmul_params, peak_bytes, card):
    step_s = statistics.median(log.secs[TRAIN_TIMED])
    return dict(step_ms=step_s * 1e3, step_ms_range=[min(log.secs[TRAIN_TIMED]) * 1e3,
                                                     max(log.secs[TRAIN_TIMED]) * 1e3],
                tokens=tokens, tokens_per_s=tokens / step_s,
                mfu=6 * matmul_params * tokens / step_s / PEAK_FLOPS["bfloat16"],
                peak_gb=peak_bytes / 1e9, losses=log.losses, grad_norms=log.gnorms, card=card)


def train_args(module, out_dir, *extra):
    """The trainer's flags for a loop over batches in memory (--train_data
    names no dataset: `train` reads only the batches it is given)."""
    return module.parse_args(["--train_data", "memory", "--output_dir", str(out_dir),
                              "--max_steps", str(TRAIN_STEPS), "--learning_rate", str(TRAIN_LR),
                              "--warmup_steps", "2", "--logging_steps", "4",
                              "--save_steps", "1000", "--seed", str(TRAIN_SEED), *extra])


def drive_training(engine, frontend, da, mg, card):
    """Phase 5j: the trainers on the card (see the module docstring).
    Returns (record, launches of the served request). The device is the
    engine's: a CPU rehearsal at a tiny config passes a CPU engine."""
    import shutil
    import tempfile

    import torch

    from flowmirror_hydravox_tpu_torch import __main__ as launcher
    from flowmirror_hydravox_tpu_torch.models import llm as llm_model
    from flowmirror_hydravox_tpu_torch.noise import TorchNoise
    from flowmirror_hydravox_tpu_torch.params import init_flow_params, init_llm_params
    from flowmirror_hydravox_tpu_torch.runtime.engine import Engine
    from flowmirror_hydravox_tpu_torch.train import checkpoint, data, steps, train_flow, train_llm

    cfg, dev = engine.cfg, torch.device(engine.device)
    on_card = dev.type == "cuda"
    rec = {"cross_device": train_cross_device(cfg, frontend.tokenizer, dev)}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="hydravox_train_"))
    model_dir = tmp / "model"
    model_dir.mkdir()
    rng = np.random.default_rng(TRAIN_SEED + 1)

    def gen():
        return torch.Generator(device=dev).manual_seed(TRAIN_SEED)

    try:
        # 5j.2: the LLM at full depth, bf16, through train_llm's loop
        b, lt, ls = TRAIN_LLM
        t0 = time.time()
        llm_batches = collated(data.LLMCollator(frontend.tokenizer),
                               llm_rows(rng, b * TRAIN_STEPS, cfg.llm), b,
                               {"text_token": (b, lt), "speech_token": (b, ls)})
        rec["llm_collate_s"] = time.time() - t0
        params = init_llm_params(cfg.llm, gen(), dev, torch.bfloat16)
        p_mm = sum(steps.matmul_params(params[k]) for k in ("mtp_block", "llm_decoder")) + \
            steps.matmul_params(params["backbone"]["layers"])
        log = StepLog("llm", dev, frozen=MTP_DEAD, moments_at=RESUME_AT + 2)
        da.launch_count = mg.launch_count = mg.int8_launch_count = 0
        reset_peak(dev)
        state, _ = train_llm.train(train_args(train_llm, tmp / "llm"), cfg.llm, params,
                                   llm_batches, on_step=log)
        if state.step != TRAIN_STEPS:
            fail(f"5j llm: the loop ended at step {state.step}")
        shutil.rmtree(tmp / "llm")
        rec["llm"] = train_figures(log, b * (2 + lt + ls), p_mm, peak_bytes(dev), card)
        checkpoint.save_params_npz(str(model_dir / "llm.npz"), state.params)
        trained_decoder = state.params["llm_decoder"].detach().clone()
        del state, params

        # 5j.5: the same run cut after RESUME_AT steps (its batches run out,
        # the loop saves the train state), restored into a fresh loop for two
        # steps. The first resumed loss is computed before any update, so the
        # optimizer state shows only in the second loss and in the moments
        # and count after it, each held against the uninterrupted run's.
        params = init_llm_params(cfg.llm, gen(), dev, torch.bfloat16)
        train_llm.train(train_args(train_llm, tmp / "resume"), cfg.llm, params,
                        llm_batches[:RESUME_AT])
        del params
        resumed = StepLog("llm resumed", dev, moments_at=RESUME_AT + 2)
        params = init_llm_params(cfg.llm, torch.Generator(device=dev).manual_seed(0), dev,
                                 torch.bfloat16)
        state, _ = train_llm.train(
            train_args(train_llm, tmp / "resume", "--resume", str(tmp / "resume")),
            cfg.llm, params, llm_batches[RESUME_AT:RESUME_AT + 2], on_step=resumed)
        if state.step != RESUME_AT + 2 or len(resumed.losses) != 2:
            fail(f"5j resume: ended at step {state.step} after {len(resumed.losses)} steps")
        del state, params
        got = {f"loss{RESUME_AT + 1}": resumed.losses[0], f"loss{RESUME_AT + 2}": resumed.losses[1],
               **resumed.moments}
        want = {f"loss{RESUME_AT + 1}": log.losses[RESUME_AT],
                f"loss{RESUME_AT + 2}": log.losses[RESUME_AT + 1], **log.moments}
        rel = {k: abs(got[k] - want[k]) / abs(want[k]) for k in want}
        rec["resume"] = dict(steps=[RESUME_AT + 1, RESUME_AT + 2], resumed=got,
                             uninterrupted=want, rel=rel)
        print("5j resume", json.dumps(rec["resume"]), flush=True)
        if got["count"] != want["count"] or max(rel.values()) > RESUME_TOL:
            fail(f"5j resume: resumed {got}, uninterrupted {want}")
        shutil.rmtree(tmp / "resume")

        # 5j.2: FIXED_STEPS steps on one batch of FIXED_CODES codes must learn it
        codes = rng.choice(cfg.llm.speech_token_size, FIXED_CODES, replace=False)
        fixed = steps.batch_to(collated(data.LLMCollator(frontend.tokenizer),
                                        llm_rows(rng, b, cfg.llm, codes), b,
                                        {"speech_token": (b, ls)})[0], dev)
        opt = steps.Optimizer(steps.OptimConfig(learning_rate=TRAIN_LR, schedule="constant"))
        state = steps.init_state(init_llm_params(cfg.llm, gen(), dev, torch.bfloat16), opt)
        losses = [float(steps.llm_train_step(state, fixed, cfg.llm, opt)[1]["loss"])
                  for _ in range(FIXED_STEPS)]
        with torch.no_grad():
            final = float(llm_model.forward_loss(state.params, cfg.llm, *(fixed[k] for k in (
                "text_token", "text_len", "speech_token", "speech_len")))["loss"])
        del state
        rec["llm_fixed_batch"] = dict(first=losses[0], final=final, ratio=final / losses[0],
                                      losses=losses)
        print("5j llm fixed batch", json.dumps({k: v for k, v in rec["llm_fixed_batch"].items()
                                                 if k != "losses"}), flush=True)
        if not final < 0.9 * losses[0]:
            fail(f"5j: {FIXED_STEPS} steps on one batch took the LLM loss from {losses[0]} to "
                 f"{final}, not below 0.9 x")

        # 5j.3: the flow at full depth, bf16, through train_flow's loop
        fb, flt = TRAIN_FLOW
        t0 = time.time()
        flow_batches = collated(data.FlowCollator(), flow_rows(rng, fb * TRAIN_STEPS, cfg.flow),
                                fb,
                                {"speech_token": (fb, flt), "speech_feat": (fb, 2 * flt, 80)})
        rec["flow_collate_s"] = time.time() - t0
        params = init_flow_params(cfg.flow, gen(), dev, torch.bfloat16)
        noise0 = params["rand_noise"].clone()
        log_f = StepLog("flow", dev, frozen=("rand_noise",))
        reset_peak(dev)
        fargs = train_args(train_flow, tmp / "flow")
        state, _ = train_flow.train(fargs, cfg.flow, params, flow_batches, on_step=log_f)
        if state.step != TRAIN_STEPS:
            fail(f"5j flow: the loop ended at step {state.step}")
        rec["flow"] = train_figures(log_f, fb * 2 * flt, steps.matmul_params(state.params),
                                    peak_bytes(dev), card)
        # rand_noise has no gradient: each applied step's decay alone moves it
        sched = steps.make_schedule(steps.OptimConfig(learning_rate=TRAIN_LR, warmup_steps=2,
                                                      total_steps=TRAIN_STEPS))
        want, factor = noise0, 1.0
        for count in range(TRAIN_STEPS):
            want = want + (want * 0.01) * -sched(count)
            factor *= 1 - sched(count) * 0.01
        got = state.params["rand_noise"].detach()
        rec["flow"]["rand_noise"] = dict(
            ratio=float(got.double().sum() / noise0.double().sum()), predicted=factor,
            max_err=float((got - want).abs().max()))
        if rec["flow"]["rand_noise"]["max_err"] > 1e-6 * float(noise0.abs().max()):
            fail(f"5j flow: rand_noise is not the decayed buffer: {rec['flow']['rand_noise']}")
        checkpoint.save_params_npz(str(model_dir / "flow.npz"), state.params)
        del state, params
        if (da.launch_count, mg.launch_count, mg.int8_launch_count) != (0, 0, 0):
            fail(f"5j: training launched a kernel: attention {da.launch_count}, MLP "
                 f"{mg.launch_count}, int8 MLP {mg.int8_launch_count}")

        # 5j.3: FIXED_STEPS steps on one batch whose mel follows its tokens
        templates = rng.standard_normal((FIXED_CODES, 2, 80))
        fixed = steps.batch_to(collated(data.FlowCollator(), flow_rows(rng, fb, cfg.flow, templates),
                                        fb, {"speech_token": (fb, flt)})[0], dev)
        state = steps.init_state(init_flow_params(cfg.flow, gen(), dev, torch.bfloat16), opt)
        noise = TorchNoise(gen())
        losses = [float(steps.flow_train_step(state, fixed, noise, cfg.flow, opt)[1]["loss"])
                  for _ in range(FIXED_STEPS)]
        del state
        early, late = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        rec["flow_fixed_batch"] = dict(mean_1_10=early, mean_21_30=late, losses=losses)
        print("5j flow fixed batch", json.dumps({"mean_1_10": early, "mean_21_30": late}),
              flush=True)
        if not late < early:
            fail(f"5j: the flow's loss on one batch did not fall: {early} then {late}")
        for name in ("llm", "flow"):
            r = rec[name]
            print(f"5j {name} train step", json.dumps({k: v for k, v in r.items()
                                                       if k not in ("losses", "grad_norms")}),
                  flush=True)

        # 5j.4: the trained checkpoint served through both kernels
        t0 = time.time()
        cfg_s, trees = launcher.load_models(not on_card, str(model_dir), frontend.tokenizer, dev)
        if not torch.equal(trees["llm"]["llm_decoder"], trained_decoder):
            fail("5j: the served llm_decoder is not the trained one")
        served = Engine(cfg_s, trees["llm"], trees["flow"], trees["hift"], max_tokens=MAX_TOKENS,
                        device=dev)
        rec["load_s"] = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    servers = start_servers(served, frontend, window={})
    try:
        with EngineCalls(served) as calls:
            da.launch_count = mg.launch_count = 0
            recs, launched, (samples, peak) = held_worker(
                "5j trained checkpoint, /api/v1/tts", calls, da, mg, cfg_s.llm,
                lambda: tts(servers["window"][2], TRAIN_TEXT, 2, seed=TRAIN_SEED),
                [("synthesize", 1)])
        rec["served"] = dict(tokens=recs[0]["tokens"], steps=recs[0]["steps"],
                             audio_s=samples / SAMPLE_RATE, peak=peak,
                             attention_launches=launched[0], mlp_launches=launched[1],
                             predicted=list(predicted_launches(recs, cfg_s.llm)))
        print("5j served", json.dumps(rec["served"]), flush=True)
        return rec, launched
    finally:
        stop_servers(servers)
        del served
        torch.cuda.empty_cache()


# phase 5k: DPO at full width
DPO_SHAPE = (4, 64, 256)  # B pairs, text bucket, speech bucket: bench_train --which dpo's point
DPO_STEPS = 10
DPO_TOL = 1e-3  # step 1: dpo_loss against ln 2, rewards against 0 (bf16)
# the card-vs-CPU DPO step at f32, on the 2-layer, 2-head config of 5j.1
DPO_CROSS_REL = 1e-5  # loss, dpo_loss, grad norm
DPO_CROSS_PARAMS = 2e-5  # x (1 + |p|), one step at CROSS_LR


def dpo_rows(rng, n_rows, llm_cfg, speech_len=(200, 257)):
    """Seeded DPO rows: LLM rows whose speech tokens are the chosen side and
    a second draw of the same lengths the rejected side."""
    rows = llm_rows(rng, n_rows, llm_cfg, speech_len=speech_len)
    for r in rows:
        r["reject_speech_token"] = rng.integers(0, llm_cfg.speech_token_size,
                                                int(rng.integers(*speech_len))).tolist()
    return rows


def dpo_cross_device(cfg, tokenizer, dev):
    """5k.1: one dpo_train_step at f32 on the card and on the CPU from the
    same seeded weights (the reference model a copy) and batch: the
    full-width LLM at 2 layers and 2 MTP heads, as 5j.1. Loss, dpo_loss and
    grad norm within DPO_CROSS_REL relative, params within DPO_CROSS_PARAMS
    x (1 + |p|), the gradients (Adam's first moments) within CROSS_TOL of
    each leaf's largest."""
    import dataclasses

    import torch

    from flowmirror_hydravox_tpu_torch.params import init_llm_params
    from flowmirror_hydravox_tpu_torch.train import data, steps
    from flowmirror_hydravox_tpu_torch.train.train_dpo import frozen_copy

    rng = np.random.default_rng(TRAIN_SEED + 2)
    llm_cfg = dataclasses.replace(cfg.llm, head_num=2, backbone=dataclasses.replace(
        cfg.llm.backbone, num_layers=2))
    batch = data.DPOCollator(tokenizer)(dpo_rows(rng, 2, llm_cfg, speech_len=(100, 129)))
    opt = steps.Optimizer(steps.OptimConfig(learning_rate=CROSS_LR, schedule="constant"))
    cpu_params = init_llm_params(llm_cfg, torch.Generator().manual_seed(TRAIN_SEED), "cpu",
                                 torch.float32)
    runs = {}
    for where, params in (("card", tree_to_device(cpu_params, dev)), ("cpu", cpu_params)):
        ref = frozen_copy(params)
        state, m = steps.dpo_train_step(steps.init_state(params, opt), ref,
                                        steps.batch_to(batch, params["llm_decoder"].device),
                                        llm_cfg, opt)
        runs[where] = (state, m)
    (card, m_card), (cpu, m_cpu) = runs["card"], runs["cpu"]
    rec = {f"{k}_rel": abs(float(m_card[k]) - float(m_cpu[k])) / abs(float(m_cpu[k]))
           for k in ("loss", "dpo_loss", "grad_norm")}
    rec.update(loss=float(m_card["loss"]), dpo_loss=float(m_card["dpo_loss"]),
               params_err=leaf_err(card.params, cpu.params),
               grad_err=grad_err(card.opt_state, cpu.opt_state),
               batch={k: list(v.shape) for k, v in batch.items()})
    print("5k card vs CPU dpo", json.dumps(rec), flush=True)
    if (max(rec["loss_rel"], rec["dpo_loss_rel"], rec["grad_norm_rel"]) > DPO_CROSS_REL
            or rec["params_err"] > DPO_CROSS_PARAMS or rec["grad_err"] > CROSS_TOL):
        fail(f"5k: the card's DPO step differs from the CPU's: {rec}")
    return rec


def check_dpo_heads(state):
    """After step 1: head 0's slice of every head leaf but the
    never-multiplied q/k has a gradient (Adam's first moment), heads 1-4's
    slices exactly none, as in JAX (forward_dpo runs head 0 alone)."""
    for k, mu in state.opt_state["mu"].items():
        if not k.startswith("mtp_block.") or k in MTP_DEAD:
            continue
        per_head = mu.abs().flatten(1).amax(1)
        if not (float(per_head[0]) > 0 and not bool(per_head[1:].any())):
            fail(f"5k: {k} per-head gradient {per_head.tolist()}: expected head 0 alone")


def drive_dpo(engine, frontend, da, mg, card):
    """Phase 5k: DPO on the card (see the module docstring). Returns the
    record. A CPU rehearsal at a tiny config passes a CPU engine."""
    import shutil
    import tempfile

    import torch

    from flowmirror_hydravox_tpu_torch.params import flatten_params, init_llm_params
    from flowmirror_hydravox_tpu_torch.tools import bench_train
    from flowmirror_hydravox_tpu_torch.train import data, steps, train_dpo

    cfg, dev = engine.cfg, torch.device(engine.device)
    on_card = dev.type == "cuda"
    rec = {"cross_device": dpo_cross_device(cfg, frontend.tokenizer, dev)}
    rng = np.random.default_rng(TRAIN_SEED + 3)
    b, lt, ls = DPO_SHAPE
    t0 = time.time()
    (fixed,) = collated(data.DPOCollator(frontend.tokenizer), dpo_rows(rng, b, cfg.llm), b,
                        {"text_token": (b, lt), "chosen_token": (b, ls),
                         "rejected_token": (b, ls)})
    rec["collate_s"] = time.time() - t0
    params = init_llm_params(cfg.llm, torch.Generator(device=dev).manual_seed(TRAIN_SEED), dev,
                             torch.bfloat16)
    ref = train_dpo.frozen_copy(params)
    ref_before = {k: v.clone() for k, v in flatten_params(ref).items()}
    log = StepLog("dpo", dev, frozen=MTP_DEAD)

    def on_step(state, metrics):
        log(state, metrics)
        if (da.launch_count, mg.launch_count, mg.int8_launch_count) != (0, 0, 0):
            fail(f"5k: DPO step {state.step} launched a kernel: attention {da.launch_count}, "
                 f"MLP {mg.launch_count}, int8 MLP {mg.int8_launch_count}")
        if state.step == 1:
            check_dpo_heads(state)

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="hydravox_dpo_"))
    try:
        args = train_dpo.parse_args([
            "--train_data", "memory", "--output_dir", str(tmp), "--max_steps", str(DPO_STEPS),
            "--learning_rate", str(TRAIN_LR), "--warmup_steps", "2", "--logging_steps", "5",
            "--save_steps", "1000", "--seed", str(TRAIN_SEED)])
        da.launch_count = mg.launch_count = mg.int8_launch_count = 0
        reset_peak(dev)
        state, _ = train_dpo.train(args, cfg.llm, params, ref, [fixed] * DPO_STEPS,
                                   on_step=on_step)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if state.step != DPO_STEPS:
        fail(f"5k: the loop ended at step {state.step}")
    first = log.metrics[0]
    rec["step1"] = {k: first[k] for k in ("loss", "sft_loss", "dpo_loss", "chosen_reward",
                                          "reject_reward", "dpo_acc")}
    if not (abs(first["dpo_loss"] - np.log(2)) <= DPO_TOL and abs(first["chosen_reward"])
            <= DPO_TOL and abs(first["reject_reward"]) <= DPO_TOL):
        fail(f"5k: step 1 with the policy equal to the reference: {rec['step1']}")
    changed = [k for k, v in flatten_params(ref).items() if not torch.equal(v, ref_before[k])]
    if changed:
        fail(f"5k: the reference model changed: {changed[:5]}")
    if not log.losses[-1] < log.losses[0]:
        fail(f"5k: the total loss on the fixed batch did not fall: {log.losses}")
    step_s = statistics.median(log.secs[TRAIN_TIMED])
    p_mm = steps.matmul_params(state.params)
    tokens = b * (2 + lt + ls)
    rec.update(steps=DPO_STEPS, step_ms=step_s * 1e3,
               step_ms_range=[min(log.secs[TRAIN_TIMED]) * 1e3, max(log.secs[TRAIN_TIMED]) * 1e3],
               pairs_per_s=b / step_s, tokens=tokens, matmul_params=p_mm,
               mfu=(6 * 2 + 2 * 2) * p_mm * tokens / step_s / PEAK_FLOPS["bfloat16"],
               peak_gb=peak_bytes(dev) / 1e9, losses=log.losses,
               dpo_losses=[m["dpo_loss"] for m in log.metrics], card=card)
    del state, params, ref, ref_before
    print("5k dpo train step", json.dumps({k: v for k, v in rec.items()
                                           if k not in ("cross_device",)}), flush=True)
    # the benchmark's own lines (JAX's text vocab, 151936)
    bench_cfg = type(cfg)().llm if on_card else cfg.llm
    shapes = ((4, 64, 256), (16, 64, 256)) if on_card else ((2, 8, 16), (2, 8, 16))
    rec["bench_train"] = [
        bench_train.bench_dpo(bench_cfg, dev, *shapes[0], 10, 989.0),
        bench_train.bench_llm(bench_cfg, dev, 2 * shapes[1][0], *shapes[1][1:], 10, 989.0,
                              accum=2)]
    for line in rec["bench_train"]:
        print("5k bench_train", json.dumps(line), flush=True)
    if on_card:
        torch.cuda.empty_cache()
    return rec


# phase 5l: the spec readout trained on the card, served through the spec decode
READOUT_STEPS = 150  # of the JAX tool's 400: the whole run's time limit (acc ~0.4 at 100)
# bench_spec's defaults, but 1 rep of its 4: the whole run's time limit
SPEC_BENCH = dict(heads=4, reps=1, n_tokens=125, text_len=63)


def drive_spec_readout(engine, frontend, da, mg, flush):
    """Phase 5l (see the module docstring). Returns (record, launches)."""
    import torch

    from flowmirror_hydravox_tpu_torch.tools import bench_spec
    from flowmirror_hydravox_tpu_torch.tools import train_spec_ckpt as tool

    dev = torch.device(engine.device)
    on_card = dev.type == "cuda"
    tiny = not on_card
    steps = READOUT_STEPS if on_card else 20
    bench_kw = SPEC_BENCH if on_card else dict(SPEC_BENCH, reps=1, n_tokens=48, text_len=24)
    cfg, trees, tree = tool.load_tree(tiny, dev, frontend.tokenizer)
    m_tokens = min(256, cfg.llm.speech_token_size)
    t0 = time.time()
    tr, history = tool.train_readout(trees["llm"], cfg.llm, steps=steps, m_tokens=m_tokens,
                                     log=lambda line: print("5l", line, flush=True))
    if on_card:
        torch.cuda.synchronize()
    train_s = time.time() - t0
    meta = dict(tree, steps=steps, batch=4, lt_max=64, ls=160, m_tokens=m_tokens, lr=2e-3,
                train_embedding=True, train_acc=round(history[-1][2], 4),
                torch=torch.__version__, recipe="chip_smoke phase 5l (tools/train_spec_ckpt.py)")
    tool.save_spec_readout(tool.DEFAULT_OUT, tr, meta)
    rec = dict(steps=steps, train_s=train_s, history=history, artifact=tool.DEFAULT_OUT,
               artifact_bytes=pathlib.Path(tool.DEFAULT_OUT).stat().st_size)
    print("5l readout training", json.dumps(rec), flush=True)
    (_, loss0, acc0), (_, loss1, acc1) = history[0], history[-1]
    if not (loss1 < loss0 and acc1 > acc0):
        fail(f"5l: the readout did not learn: loss {loss0} -> {loss1}, acc {acc0} -> {acc1}")
    trained = tool.with_readout(trees["llm"], tr)
    # a fresh draw of the seed-0 tree takes the artifact back bit for bit
    _, fresh, _ = tool.load_tree(tiny, dev, frontend.tokenizer)
    loaded, _ = tool.load_spec_readout(fresh["llm"], tool.DEFAULT_OUT, tree)
    for k in ("llm_decoder", "speech_embedding"):
        if not torch.equal(loaded[k], trained[k]):
            fail(f"5l: the loaded readout's {k} is not the trained one")
    del fresh, loaded, tr

    out, recs = {}, []
    da.launch_count = mg.launch_count = 0
    for name, llm in (("untrained", trees["llm"]), ("trained", trained)):
        eng = bench_spec.spec_engine(cfg, dict(trees, llm=llm), bench_kw["n_tokens"], dev)

        def log(line, name=name):
            print(f"5l {name}", line, flush=True)

        with EngineCalls(eng) as calls:
            runs = [bench_spec.bench(eng, heads, bench_kw["reps"], bench_kw["n_tokens"],
                                     bench_kw["text_len"], True, log)
                    for heads in (bench_kw["heads"], 1)]
        out[name] = dict(bench_spec.summarize(*runs), decodes=len(calls.records))
        recs += calls.records
        del eng
    launched = (da.launch_count, mg.launch_count)
    spec_recs = [r for r in recs if r["heads"] > 1]
    blind_recs = [r for r in recs if r["heads"] == 1]
    predicted = tuple(a + b for a, b in zip(predicted_spec_launches(spec_recs, cfg.llm),
                                            predicted_launches(blind_recs, cfg.llm)))
    rec.update(bench=out, launches=list(launched), predicted=list(predicted))
    print("5l spec decode", json.dumps({k: rec[k] for k in ("bench", "launches", "predicted")}),
          flush=True)
    if launched != predicted or 0 in launched:
        fail(f"5l: (attention, mlp) launches {launched}, predicted {predicted}")
    if not out["trained"]["acceptance"] > out["untrained"]["acceptance"]:
        fail(f"5l: acceptance with the trained readout {out['trained']['acceptance']}, "
             f"untrained {out['untrained']['acceptance']}")
    del trained, trees
    return rec, launched


# phase 5m: HiFT GAN training on the card
GAN_SEED = 37
GAN_SHAPE = (4, 32)  # B, mel frames (15,360 samples): bench_train --which gan's point
GAN_CROSS = (1, 8)  # the card-vs-CPU step's B, mel frames
GAN_STEPS = 12
GAN_FIXED_STEPS = 30
GAN_LR = 2e-4  # train_hift's default
GAN_ROWS = 16  # rows in memory: half precomputed features, half 16 kHz audio


def gan_optimizer(lr, schedule="constant"):
    from flowmirror_hydravox_tpu_torch.train import steps

    return steps.Optimizer(steps.OptimConfig(learning_rate=lr, schedule=schedule,
                                             weight_decay=0.0, b1=0.8, b2=0.99))


def gan_rows(rng, n_rows, mel_cfg):
    """Seeded rows of 0.8-1.6 s of voiced audio: the first half at 24 kHz
    with precomputed features (the port's mel of the audio, a pitch track),
    the rest as 16 kHz audio rows for the trainer's featurize."""
    import torch

    from flowmirror_hydravox_tpu_torch.utils import audio as audio_utils

    rows = []
    for i in range(n_rows):
        seconds = float(rng.uniform(0.8, 1.6))
        seed = int(rng.integers(1 << 30))
        if i < n_rows // 2:
            wav = voiced(mel_cfg.sample_rate, seconds, seed)
            mel = audio_utils.mel_spectrogram(
                torch.from_numpy(wav)[None], mel_cfg.n_fft, mel_cfg.num_mels,
                mel_cfg.sample_rate, mel_cfg.hop_size, mel_cfg.win_size)[0].T.numpy()
            rows.append({"speech": wav, "speech_feat": mel,
                         "pitch_feat": (110 + 40 * rng.random(len(mel))).astype(np.float32)})
        else:
            rows.append({"audio": {"array": voiced(16000, seconds, seed), "sampling_rate": 16000}})
    return rows


def gan_cross_device(cfg, dev):
    """5m.1: one gan_train_step at f32 on the card and on the CPU from the
    same weights (full-width HiFT and discriminators), batch (B 1, 8 frames)
    and vocoder draws. Both losses and grad norms within CROSS_TOL relative,
    params within CROSS_TOL x (1 + |p|), Adam's first moments within
    CROSS_TOL of each leaf's largest, for each model."""
    import torch

    from flowmirror_hydravox_tpu_torch.params import init_disc_params, init_hift_params
    from flowmirror_hydravox_tpu_torch.train import gan, steps

    b, frames = GAN_CROSS
    rng = np.random.default_rng(GAN_SEED)
    batch = {"speech_feat": (rng.standard_normal((b, frames, 80)) - 4.0).astype(np.float32),
             "speech": (rng.standard_normal((b, frames * cfg.hift.upsample_scale)) * 0.1).astype(
                 np.float32),
             "pitch_feat": (np.abs(rng.standard_normal((b, frames))) * 200.0).astype(np.float32)}
    gen = torch.Generator().manual_seed(GAN_SEED)
    trees = {"gen": init_hift_params(cfg.hift, gen, "cpu", torch.float32),
             "disc": init_disc_params(gen, "cpu", torch.float32)}
    opt = gan_optimizer(CROSS_LR)
    out = {}
    for where in ("card", "cpu"):
        d = dev if where == "card" else torch.device("cpu")
        states = {k: steps.init_state(tree_to_device(t, d), opt) for k, t in trees.items()}
        states["gen"], states["disc"], m = gan.gan_train_step(
            states["gen"], states["disc"], steps.batch_to(batch, d), DrawsOn(GAN_SEED, d),
            cfg.hift, opt, opt)
        out[where] = (states, {k: float(v) for k, v in m.items()})
    (card, m_card), (cpu, m_cpu) = out["card"], out["cpu"]
    rec = {f"{k}_rel": abs(m_card[k] - m_cpu[k]) / abs(m_cpu[k])
           for k in ("gen_loss", "gen_grad_norm", "disc_loss", "disc_grad_norm")}
    for k in ("gen", "disc"):
        rec[f"{k}_params_err"] = leaf_err(card[k].params, cpu[k].params)
        rec[f"{k}_grad_err"] = grad_err(card[k].opt_state, cpu[k].opt_state)
    rec.update(metrics=m_card, batch={k: list(v.shape) for k, v in batch.items()})
    print("5m card vs CPU", json.dumps(rec), flush=True)
    if max(v for k, v in rec.items() if k.endswith(("_rel", "_err"))) > CROSS_TOL:
        fail(f"5m: the card's GAN step differs from the CPU's: {rec}")
    return rec


class GanLog:
    """train_hift.train's `on_step`: synchronises the card, records each
    step's wall time and metrics, fails on a non-finite loss or grad norm and
    on any kernel launch in the step, and after step 2 (step 1's learning
    rate is the warm-up's 0) requires every leaf of both models to have
    moved from `start` ({"gen", "disc"}: flat copies of the initial trees)."""

    def __init__(self, dev, da, mg, start):
        self.dev, self.da, self.mg, self.start = dev, da, mg, start
        self.secs, self.metrics = [], []
        self.t = time.perf_counter()

    def __call__(self, gen_state, disc_state, metrics):
        import torch

        from flowmirror_hydravox_tpu_torch.params import flatten_params

        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.secs.append(now - self.t)
        self.t = now
        m = {k: float(v) for k, v in metrics.items()}
        self.metrics.append(m)
        step = gen_state.step
        if not all(np.isfinite(m[k]) for k in ("gen_loss", "gen_grad_norm", "disc_loss",
                                                "disc_grad_norm")):
            fail(f"5m: step {step} {m}")
        launched = (self.da.launch_count, self.mg.launch_count, self.mg.int8_launch_count)
        if launched != (0, 0, 0):
            fail(f"5m: GAN step {step} launched a kernel: (attention, MLP, int8 MLP) {launched}")
        if step == 2:
            for name, state in (("gen", gen_state), ("disc", disc_state)):
                still = [k for k, p in flatten_params(state.params).items()
                         if torch.equal(p, self.start[name][k])]
                if still:
                    fail(f"5m: after step 2, {len(still)} {name} leaves did not move: "
                         f"{still[:5]}")
            self.start = None


def drive_gan(engine, frontend, da, mg, card):
    """Phase 5m: HiFT GAN training on the card (see the module docstring).
    Returns (record, launches of the served request)."""
    import shutil
    import tempfile

    import torch

    from flowmirror_hydravox_tpu_torch import __main__ as launcher
    from flowmirror_hydravox_tpu_torch.noise import TorchNoise
    from flowmirror_hydravox_tpu_torch.params import (flatten_params, init_disc_params,
                                                      init_hift_params)
    from flowmirror_hydravox_tpu_torch.runtime.engine import Engine
    from flowmirror_hydravox_tpu_torch.tools import bench_train
    from flowmirror_hydravox_tpu_torch.train import gan, steps, train_hift

    cfg, dev = engine.cfg, torch.device(engine.device)
    on_card = dev.type == "cuda"

    def no_launch(what):
        launched = (da.launch_count, mg.launch_count, mg.int8_launch_count)
        if launched != (0, 0, 0):
            fail(f"5m: {what} launched a kernel: (attention, MLP, int8 MLP) {launched}")

    # every GAN step of 5m, the card-vs-CPU one and the benchmark's included,
    # runs with the counts at 0 and is checked for launches
    da.launch_count = mg.launch_count = mg.int8_launch_count = 0
    rec = {"cross_device": gan_cross_device(cfg, dev)}
    no_launch("the card-vs-CPU GAN step")
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="hydravox_gan_"))
    model_dir = tmp / "model"
    model_dir.mkdir()
    b, frames = GAN_SHAPE
    t_audio = frames * cfg.hift.upsample_scale
    try:
        # 5m.2: train_hift's loop at full width, f32, over rows in memory
        args = train_hift.parse_args([
            "--train_data", "memory", "--output_dir", str(tmp / "hift"), "--batch_size", str(b),
            "--segment_frames", str(frames), "--max_steps", str(GAN_STEPS),
            "--learning_rate", str(GAN_LR), "--logging_steps", "4", "--save_steps", "1000",
            "--seed", str(GAN_SEED)])
        t0 = time.time()
        rows = gan_rows(np.random.default_rng(GAN_SEED + 1), GAN_ROWS, cfg.mel)
        rec["rows_s"] = time.time() - t0
        gen = torch.Generator(device=dev).manual_seed(GAN_SEED)
        gen_params = init_hift_params(cfg.hift, gen, dev, torch.float32)
        disc_params = init_disc_params(gen, dev, torch.float32)
        start = {"gen": {k: p.clone() for k, p in flatten_params(gen_params).items()},
                 "disc": {k: p.clone() for k, p in flatten_params(disc_params).items()}}
        log = GanLog(dev, da, mg, start)
        del start
        reset_peak(dev)
        gen_state, disc_state, _ = train_hift.train(
            args, cfg.hift, gen_params, disc_params,
            train_hift.batches(rows, b, frames, GAN_SEED, cfg.hift.upsample_scale, cfg.mel),
            on_step=log)
        if gen_state.step != GAN_STEPS or len(log.secs) != GAN_STEPS:
            fail(f"5m: the loop ended at step {gen_state.step}")
        step_s = statistics.median(log.secs[TRAIN_TIMED])
        rec["train"] = dict(
            step_ms=step_s * 1e3, step_ms_range=[min(log.secs[TRAIN_TIMED]) * 1e3,
                                                 max(log.secs[TRAIN_TIMED]) * 1e3],
            batch=[b, frames, t_audio], audio_sec_per_sec=b * t_audio / cfg.mel.sample_rate / step_s,
            peak_gb=peak_bytes(dev) / 1e9, card=card, metrics=log.metrics)
        print("5m train step", json.dumps({k: v for k, v in rec["train"].items()
                                           if k != "metrics"}), flush=True)
        shutil.copy(tmp / "hift" / "hift_final.npz", model_dir / "hift.npz")
        trained = {k: p.detach().clone() for k, p in flatten_params(gen_state.params).items()}
        del gen_state, disc_state, gen_params, disc_params

        # 5m.3: GAN_FIXED_STEPS steps at a constant GAN_LR on one batch: the
        # mel term of steps 21-30 must fall below that of steps 1-10
        fixed = steps.batch_to(next(train_hift.batches(rows, b, frames, GAN_SEED + 2,
                                                       cfg.hift.upsample_scale, cfg.mel)), dev)
        opt = gan_optimizer(GAN_LR)
        gen = torch.Generator(device=dev).manual_seed(GAN_SEED)
        gs = steps.init_state(init_hift_params(cfg.hift, gen, dev, torch.float32), opt)
        ds = steps.init_state(init_disc_params(gen, dev, torch.float32), opt)
        noise = TorchNoise(torch.Generator(device=dev).manual_seed(GAN_SEED + 1))
        mels = []
        for _ in range(GAN_FIXED_STEPS):
            gs, ds, m = gan.gan_train_step(gs, ds, fixed, noise, cfg.hift, opt, opt)
            mels.append(float(m["mel"]))
        del gs, ds
        early, late = float(np.mean(mels[:10])), float(np.mean(mels[-10:]))
        rec["fixed_batch"] = dict(mel_mean_1_10=early, mel_mean_21_30=late, mel=mels)
        print("5m fixed batch", json.dumps({"mel_mean_1_10": early, "mel_mean_21_30": late}),
              flush=True)
        if not late < early:
            fail(f"5m: the mel term on one batch did not fall: {early} then {late}")
        no_launch("a fixed-batch GAN step")

        # the benchmark's own line
        if on_card:
            line = bench_train.bench_gan(cfg, dev, b, frames, 10)
            rec["bench_train"] = line
            print("5m bench_train", json.dumps(line), flush=True)
            no_launch("bench_train's GAN step")

        # 5m.4: the trained HiFT served through both kernels
        t0 = time.time()
        cfg_s, trees = launcher.load_models(not on_card, str(model_dir), frontend.tokenizer, dev)
        for k, p in flatten_params(trees["hift"]).items():
            if not torch.equal(p, trained[k]):
                fail(f"5m: the served HiFT's {k} is not the trained one")
        served = Engine(cfg_s, trees["llm"], trees["flow"], trees["hift"], max_tokens=MAX_TOKENS,
                        device=dev)
        rec["load_s"] = time.time() - t0
        del trained
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    servers = start_servers(served, frontend, window={})
    try:
        with EngineCalls(served) as calls:
            da.launch_count = mg.launch_count = 0
            recs, launched, (samples, peak) = held_worker(
                "5m trained HiFT, /api/v1/tts", calls, da, mg, cfg_s.llm,
                lambda: tts(servers["window"][2], TRAIN_TEXT, 2, seed=GAN_SEED),
                [("synthesize", 1)])
        rec["served"] = dict(tokens=recs[0]["tokens"], steps=recs[0]["steps"],
                             audio_s=samples / SAMPLE_RATE, peak=peak,
                             attention_launches=launched[0], mlp_launches=launched[1],
                             predicted=list(predicted_launches(recs, cfg_s.llm)))
        print("5m served", json.dumps(rec["served"]), flush=True)
        return rec, launched
    finally:
        stop_servers(servers)
        del served
        if on_card:
            torch.cuda.empty_cache()


@contextlib.contextmanager
def patched_env(env: dict):
    """`env` set in os.environ while entered, the earlier values back after."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# phase 5n: the training and model-admin routes, a route-started trainer
ROUTE_ROWS = 64  # LLM rows of the dataset the port's writer makes on the machine
ROUTE_SHAPE = dict(batch_size=8, max_steps=12, logging_steps=1, warmup_steps=2)
ROUTE_SEED = 41
ROUTE_JOB_LIMIT_S = 420  # start to completed, the 2.8 GB checkpoint read and step_12.pt write
ROUTE_STOP_AT = 2  # the long job is stopped once its log shows this step
ROUTE_GRACE_S = 10.0  # stop_training's SIGTERM -> SIGKILL grace
ROUTE_FREE_SLACK = 2 ** 30  # bytes: the card's free memory after the stop against before the job
ROUTE_SPEAKER_ROWS = 3  # 3 s voiced rows at 16 kHz of the speaker dataset


def png_check(png: bytes, what: str) -> dict:
    """A PNG's IHDR and its tEXt chunks; the IDAT must inflate to the
    RGB rows' size (a filter byte per row)."""
    import struct
    import zlib

    if png[:8] != b"\x89PNG\r\n\x1a\n":
        fail(f"{what}: no PNG signature")
    pos, chunks = 8, {}
    while pos < len(png):
        (n,), kind = struct.unpack(">I", png[pos:pos + 4]), png[pos + 4:pos + 8]
        chunks.setdefault(kind, []).append(png[pos + 8:pos + 8 + n])
        pos += 12 + n
    w, h, depth, color = struct.unpack(">IIBB", chunks[b"IHDR"][0][:10])
    raw = zlib.decompress(b"".join(chunks[b"IDAT"]))
    if (w, h, depth, color) != (990, 550, 8, 2) or len(raw) != h * (1 + 3 * w):
        fail(f"{what}: IHDR {w} x {h} depth {depth} color {color}, IDAT {len(raw)} bytes")
    text = dict(t.split(b"\0", 1) for t in chunks.get(b"tEXt", []))
    return {"width": w, "height": h, "extents": json.loads(text[b"extents"])}


def compute_pids() -> list:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def poll_job(url, tid, until, what, limit_s):
    """Status polls until `until(data, log so far)`; returns (data, log)."""
    log, deadline = "", time.time() + limit_s
    while time.time() < deadline:
        code, body = http_call(url, f"/api/v1/training/status/{tid}")
        if code != 200:
            fail(f"{what}: status {code} {body}")
        log += body["data"]["new_log"]
        if until(body["data"], log):
            return body["data"], log
        time.sleep(0.5)
    fail(f"{what}: not there within {limit_s} s; log tail:\n{log[-3000:]}")


def drive_training_routes(engine, frontend, da, mg, card):
    """Phase 5n: the training and model routes on the card (see the module
    docstring). Returns (record, launches of the two served requests)."""
    import os
    import re
    import shutil
    import tempfile

    import torch

    from flowmirror_hydravox_tpu_torch import __main__ as launcher
    from flowmirror_hydravox_tpu_torch.params import flatten_params, init_hift_params
    from flowmirror_hydravox_tpu_torch.runtime.engine import Engine
    from flowmirror_hydravox_tpu_torch.runtime.training_manager import TrainingManager
    from flowmirror_hydravox_tpu_torch.runtime.training_plots import parse_training_logs
    from flowmirror_hydravox_tpu_torch.train import checkpoint
    from flowmirror_hydravox_tpu_torch.train.data import load_hf_dataset
    from flowmirror_hydravox_tpu_torch.utils import hf_dataset

    cfg, dev = engine.cfg, torch.device(engine.device)
    rec = {}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="hydravox_routes_"))
    root = tmp / "models"
    model_dir = tmp / "served"
    for d in (root, model_dir):
        d.mkdir()
    torch.cuda.empty_cache()

    # 5n.1: the dataset, written by the port's writer on this machine
    t0 = time.time()
    rows = llm_rows(np.random.default_rng(ROUTE_SEED), ROUTE_ROWS, cfg.llm)
    ds_dir = ROOT / "chiprun_out" / "routes_llm_ds"
    shutil.rmtree(ds_dir, ignore_errors=True)
    hf_dataset.save_to_disk(rows, str(ds_dir))
    back = hf_dataset.load_from_disk(str(ds_dir))
    train_rows, _ = load_hf_dataset(str(ds_dir))
    if list(back) != rows or [train_rows[i] for i in range(len(train_rows))] != rows:
        fail("5n: the dataset read back differs from the rows written")
    rec["dataset"] = dict(rows=len(rows), seconds=time.time() - t0,
                          bytes=sum(f.stat().st_size for f in ds_dir.iterdir()))
    print("5n dataset", json.dumps(rec["dataset"]), flush=True)

    manager = TrainingManager(device="cuda")
    servers = start_servers(engine, frontend, window={"training": manager})
    url = servers["window"][2]
    with patched_env({"TTS_MODEL_ROOT": str(root)}):
        try:
            # 5n.2: the seed-0 LLM as npz, fine-tuned by a route-started trainer
            t0 = time.time()
            seed0 = str(root / "seed0_llm.npz")
            checkpoint.save_params_npz(seed0, engine.llm_params)
            rec["npz_write_s"] = time.time() - t0
            run_dir = root / "run"
            req = {"model_type": "llm", "train_data": str(ds_dir), "output_dir": str(run_dir),
                   "model_checkpoint": seed0, **ROUTE_SHAPE}
            t_start = time.time()
            code, body = http_status(url, "/api/v1/training/start", req)
            if code != 200:
                fail(f"5n: /api/v1/training/start {code} {body}")
            tid = body["data"]["training_id"]
            code, body = http_status(url, "/api/v1/training/start", req)
            if code != 400:
                fail(f"5n: a second start while one runs answered {code}, not 400")
            listed = http_call(url, "/api/v1/training/list")[1]["data"]["trainings"]
            if [t["id"] for t in listed] != [tid]:
                fail(f"5n: /api/v1/training/list {listed}")
            status, log = poll_job(url, tid, lambda d, _: d["status"] != "running", "5n training",
                                   ROUTE_JOB_LIMIT_S)
            seconds = time.time() - t_start
            if status["status"] != "completed" or status["returncode"] != 0:
                fail(f"5n: the training ended {status['status']} rc {status['returncode']}:\n"
                     f"{log[-3000:]}")
            if "training on device cuda" not in log:
                fail("5n: the trainer's log does not name the cuda device")
            points = parse_training_logs(log)
            if points["steps"] != list(range(1, ROUTE_SHAPE["max_steps"] + 1)) or \
                    not np.isfinite(points["losses"]).all():
                fail(f"5n: step losses {points['steps']} {points['losses']}")
            s_per_it = [float(x) for x in
                        re.findall(r"step \d+ loss .*?\(([\d.]+) s/it\)", log)]
            req_png = urllib.request.Request(f"{url}/api/v1/training/plot/{tid}")
            with urllib.request.urlopen(req_png, timeout=120) as r:
                if r.status != 200 or r.headers.get("Content-Type") != "image/png":
                    fail(f"5n: plot {r.status} {r.headers.get('Content-Type')}")
                plot = png_check(r.read(), "5n plot")
            if plot["extents"]["points"]["steps"] != ROUTE_SHAPE["max_steps"]:
                fail(f"5n: the plot has {plot['extents']['points']} points")
            rec["training"] = dict(
                start_to_completed_s=seconds, step_ms=statistics.median(s_per_it[2:]) * 1e3,
                step_ms_range=[min(s_per_it[2:]) * 1e3, max(s_per_it[2:]) * 1e3],
                losses=points["losses"], accs=points["accs"], plot=plot, card=card,
                batch=[ROUTE_SHAPE["batch_size"], 64, 256])
            print("5n training", json.dumps({k: v for k, v in rec["training"].items()
                                             if k not in ("losses", "accs", "plot")}), flush=True)

            # 5n.3: a long job, stopped at step ROUTE_STOP_AT
            free_before = torch.cuda.mem_get_info(dev)[0]
            code, body = http_status(url, "/api/v1/training/start",
                                     {**req, "model_checkpoint": None, "max_steps": 100000,
                                      "output_dir": str(tmp / "long")})
            if code != 200:
                fail(f"5n: the long job's start {code} {body}")
            tid_long = body["data"]["training_id"]
            pid = manager.trainings[tid_long]["pid"]
            poll_job(url, tid_long, lambda d, text: f"step {ROUTE_STOP_AT} loss" in text
                     or d["status"] != "running", "5n long job", ROUTE_JOB_LIMIT_S)
            on_card = pid in compute_pids()
            free_running = torch.cuda.mem_get_info(dev)[0]
            t0 = time.time()
            code, body = http_status(url, f"/api/v1/training/stop/{tid_long}", {})
            stop_s = time.time() - t0
            state = http_call(url, f"/api/v1/training/status/{tid_long}")[1]["data"]["status"]
            if code != 200 or state != "stopped":
                fail(f"5n: stop answered {code}, status {state}")
            try:
                os.killpg(pid, 0)
                fail(f"5n: the stopped job's process group {pid} is still there")
            except ProcessLookupError:
                pass
            deadline = time.time() + ROUTE_GRACE_S
            while (pid in compute_pids() or torch.cuda.mem_get_info(dev)[0]
                   < free_before - ROUTE_FREE_SLACK) and time.time() < deadline:
                time.sleep(0.5)
            free_after = torch.cuda.mem_get_info(dev)[0]
            if pid in compute_pids() or free_after < free_before - ROUTE_FREE_SLACK:
                fail(f"5n: pid {pid} still holds the card {ROUTE_GRACE_S} s after the stop: "
                     f"{free_after / 1e9:.2f} GB free, {free_before / 1e9:.2f} before the job")
            # nvidia-smi may list host pids only: the card's free memory is the proof
            rec["stop"] = dict(stop_s=stop_s, pid_seen_on_card=on_card,
                               free_gb_before=free_before / 1e9,
                               free_gb_running=free_running / 1e9, free_gb_after=free_after / 1e9)
            print("5n stop", json.dumps(rec["stop"]), flush=True)

            # 5n.4: the model routes under TTS_MODEL_ROOT
            listed = http_call(url, "/api/v1/models/list")[1]["data"]["models"]
            kinds = {m["path"]: m["kind"] for m in listed}
            if kinds.get(os.path.join("run", f"step_{ROUTE_SHAPE['max_steps']}.pt")) != "orbax":
                fail(f"5n: /api/v1/models/list {kinds}")
            t0 = time.time()
            saved = torch.load(run_dir / f"step_{ROUTE_SHAPE['max_steps']}.pt", map_location="cpu",
                               weights_only=True)["params"]
            trained = str(root / "trained_llm.npz")
            np.savez(trained, **{k: v.to(torch.float32).numpy() for k, v in saved.items()})
            hift_a, hift_b = str(root / "hift_a.npz"), str(root / "hift_b.npz")
            checkpoint.save_params_npz(hift_a, engine.hift_params)
            checkpoint.save_params_npz(hift_b, init_hift_params(
                cfg.hift, torch.Generator().manual_seed(ROUTE_SEED), "cpu"))
            avg = root / "avg" / "avg_hift.npz"
            code, body = http_status(url, "/api/v1/models/convert",
                                     {"action": "average", "model": "hift",
                                      "inputs": [hift_a, hift_b], "dst": str(avg)})
            if code != 200:
                fail(f"5n: /api/v1/models/convert {code} {body}")
            status, log = poll_job(url, body["data"]["training_id"],
                                   lambda d, _: d["status"] != "running", "5n convert",
                                   ROUTE_JOB_LIMIT_S)
            if status["status"] != "completed":
                fail(f"5n: the convert job ended {status['status']}:\n{log[-3000:]}")
            convert_s = time.time() - t0
            with np.load(avg) as f, np.load(hift_a) as fa, np.load(hift_b) as fb:
                if set(f.files) != set(fa.files):
                    fail("5n: the average has other keys")
                for k in f.files:
                    if not np.array_equal(f[k], (fa[k] + fb[k]) / np.float32(2)):
                        fail(f"5n: the average's {k} is not the f32 mean")
            code, _ = http_status(url, "/api/v1/models/delete", {"path": "../x"})
            code_ok, body = http_status(url, "/api/v1/models/delete",
                                        {"path": os.path.join("avg", "avg_hift.npz")})
            if code != 400 or code_ok != 200 or avg.exists():
                fail(f"5n: /api/v1/models/delete answered {code} on ../x and {code_ok} {body}")
            rec["models"] = dict(listed=len(listed), convert_s=convert_s)
            print("5n models", json.dumps(rec["models"]), flush=True)

            # 5n.5: the trained LLM served through both kernels
            t0 = time.time()
            shutil.move(trained, model_dir / "llm.npz")
            cfg_s, trees = launcher.load_models(False, str(model_dir), frontend.tokenizer, dev)
            served_tree = flatten_params(trees["llm"])
            for k, v in saved.items():
                if not torch.equal(served_tree[k].cpu(), v):
                    fail(f"5n: the served LLM's {k} is not the trained one")
            del saved, served_tree
            served = Engine(cfg_s, trees["llm"], trees["flow"], trees["hift"],
                            max_tokens=MAX_TOKENS, device=dev)
            rec["load_s"] = time.time() - t0
        finally:
            manager.stop_all()
            stop_servers(servers)
            shutil.rmtree(tmp, ignore_errors=True)

    launched_all = [0, 0]
    servers = start_servers(served, frontend, window={})
    try:
        with EngineCalls(served) as calls:
            da.launch_count = mg.launch_count = 0
            recs, launched, (samples, peak) = held_worker(
                "5n trained LLM, /api/v1/tts", calls, da, mg, cfg_s.llm,
                lambda: tts(servers["window"][2], TRAIN_TEXT, 2, seed=ROUTE_SEED),
                [("synthesize", 1)])
        launched_all = [a + b for a, b in zip(launched_all, launched)]
        rec["served"] = dict(tokens=recs[0]["tokens"], steps=recs[0]["steps"],
                             audio_s=samples / SAMPLE_RATE, peak=peak,
                             attention_launches=launched[0], mlp_launches=launched[1],
                             predicted=list(predicted_launches(recs, cfg_s.llm)))
        print("5n served", json.dumps(rec["served"]), flush=True)
    finally:
        stop_servers(servers)
        del served
        torch.cuda.empty_cache()

    # 5n.6: a speaker enrolled from a dataset written here, then served
    spk_dir = ROOT / "chiprun_out" / "routes_speaker_ds"
    shutil.rmtree(spk_dir, ignore_errors=True)
    hf_dataset.save_to_disk([{"audio": {"array": voiced(16000, 3.0, ROUTE_SEED + i),
                                        "sampling_rate": 16000}}
                             for i in range(ROUTE_SPEAKER_ROWS)], str(spk_dir))
    servers = start_servers(engine, frontend, window={})
    try:
        url = servers["window"][2]
        t0 = time.time()
        code, body = http_status(url, "/api/v1/speakers/add",
                                 {"speaker_id": "from_dataset", "dataset_dir": str(spk_dir)})
        if code != 200 or body["data"]["rows_averaged"] != ROUTE_SPEAKER_ROWS:
            fail(f"5n: /api/v1/speakers/add with dataset_dir {code} {body}")
        rec["speaker"] = dict(add_s=time.time() - t0)
        with EngineCalls(engine) as calls:
            da.launch_count = mg.launch_count = 0
            recs, launched, (samples, _) = held_worker(
                "5n dataset speaker, /api/v1/tts", calls, da, mg, cfg.llm,
                lambda: audio_of(*http_status(url, "/api/v1/tts", {
                    "text": TRAIN_TEXT, "speaker_id": "from_dataset",
                    "extra_params": {"inference_head_num": 2, "seed": ROUTE_SEED}}),
                    "5n dataset speaker"),
                [("synthesize", 1)])
        launched_all = [a + b for a, b in zip(launched_all, launched)]
        rec["speaker"].update(tokens=recs[0]["tokens"], audio_s=samples / SAMPLE_RATE,
                              attention_launches=launched[0], mlp_launches=launched[1])
        print("5n speaker", json.dumps(rec["speaker"]), flush=True)
    finally:
        frontend.remove_speaker("from_dataset")
        stop_servers(servers)
    return rec, tuple(launched_all)


# phase 5o: the data-preprocessing pipeline through the data route, its output
# fed to a route-started trainer
PRE_DEVICE = "cuda"  # the card: the route's jobs, the in-process card runs, the quality bars
PRE_SEED = 43
PRE_CLIPS = 8  # speakers 300-307, utterance ids 30000+: outside the ASR's training pool
PRE_SECONDS = (4.0, 12.0)  # clip lengths, drawn from PRE_SEED
PRE_SIDECAR = (0, 3, 5, 6)  # clips whose segments get a sidecar transcript; the rest: the ASR
PRE_VAD_ATOL = 1e-4  # VAD probabilities (f32), card against the CPU
# stage 4's log-mel, card (cuFFT) against the CPU: 5d's MEL_ATOL in the bins
# within PRE_MEL_RANGE (ln 1000: 60 dB of magnitude) of the clip's loudest;
# below that the log magnifies the FFTs' rounding (~1e-7 of the peak), and
# every bin is held to PRE_MEL_QUIET_ATOL
PRE_MEL_RANGE = float(np.log(1000.0))
PRE_MEL_QUIET_ATOL = 1e-2
PRE_JOB_LIMIT_S = 300  # a stage's job, start to completed
PRE_FLOW = dict(batch_size=2, max_steps=4, logging_steps=1, warmup_steps=1, save_steps=4)
PRE_VAD_EVAL = dict(n_clips=2, snr_db=5.0, seconds=4.0)  # tests/test_preprocess_depth.py:117-135
PRE_ASR_CLIPS = 6  # tests/test_asr.py:117-130: mean TER below PRE_TER
PRE_TER = 0.25
PRE_S3_KEEP = ROOT / "chiprun_out" / "preprocess_s3a"


def data_stage(url, reqs, what):
    """POST /api/v1/data/run for each request at once, then poll every job
    to its end: each must complete with rc 0. Returns (seconds from the
    first start to the last completion, [each job's log])."""
    t0, tids = time.time(), []
    for req in reqs:
        code, body = http_status(url, "/api/v1/data/run", req)
        if code != 200:
            fail(f"5o {what}: /api/v1/data/run {code} {body}")
        tids.append(body["data"]["training_id"])
    logs = []
    for tid in tids:
        status, log = poll_job(url, tid, lambda d, _: d["status"] != "running", f"5o {what}",
                               PRE_JOB_LIMIT_S)
        if status["status"] != "completed" or status["returncode"] != 0:
            fail(f"5o {what}: the job ended {status['status']} rc {status['returncode']}:\n"
                 f"{log[-3000:]}")
        logs.append(log)
    return time.time() - t0, logs


def wav_tree(root: pathlib.Path) -> dict:
    from flowmirror_hydravox_tpu_torch.utils.wavio import decode_wav

    return {str(p.relative_to(root)): decode_wav(p.read_bytes())
            for p in sorted(root.rglob("*.wav"))}


def audio_seconds(tree: dict) -> float:
    return sum(len(w) / sr for w, sr in tree.values())


def same_wavs(a: dict, b: dict, what: str, steps: int = 1) -> float:
    """Equal file lists and rates, samples within `steps` int16 steps;
    returns the largest difference in steps."""
    if list(a) != list(b):
        fail(f"5o {what}: files {list(a)} against {list(b)}")
    worst = 0.0
    for k in a:
        if a[k][1] != b[k][1] or a[k][0].shape != b[k][0].shape:
            fail(f"5o {what}: {k} {a[k][0].shape} at {a[k][1]} Hz against "
                 f"{b[k][0].shape} at {b[k][1]} Hz")
        worst = max(worst, float(np.abs(a[k][0] - b[k][0]).max()) * 32768)
    if worst > steps + 1e-6:
        fail(f"5o {what}: {worst} int16 steps apart")
    return worst


def vad_card_cpu(s1: dict):
    """The native VAD's probabilities on the card and on the CPU for each
    stage-1 file: (largest difference, frames whose CPU probability lies
    within PRE_VAD_ATOL of 0.5, {file: those frames})."""
    from flowmirror_hydravox_tpu_torch.preprocess.vad_model import NativeVAD

    card, cpu = NativeVAD(device=PRE_DEVICE), NativeVAD(device="cpu")
    worst, near = 0.0, {}
    for k, (wav, sr) in s1.items():
        p_card, p_cpu = card(wav, sr), cpu(wav, sr)
        worst = max(worst, float(np.abs(p_card - p_cpu).max()))
        near[k] = np.flatnonzero(np.abs(p_cpu - 0.5) <= PRE_VAD_ATOL).tolist()
    return worst, sum(len(v) for v in near.values()), near


def token_flips(extractor, audio: dict, card: list, cpu: list) -> list:
    """Positions where the card's tokens differ from the CPU's, each with the
    CPU value's distance to its half-integer (5d's margin rule)."""
    import torch

    from flowmirror_hydravox_tpu_torch.frontend import speech_tokenizer as st
    from flowmirror_hydravox_tpu_torch.utils.audio import resample_linear, whisper_log_mel

    card, cpu = np.asarray(card), np.asarray(cpu)
    if card.shape != cpu.shape:
        fail(f"5o stage 4: {len(card)} tokens on the card, {len(cpu)} on the CPU")
    diff = np.flatnonzero(card != cpu)
    if not diff.size:
        return []
    wav = torch.tensor(audio["array"], dtype=torch.float32)[None]
    wav16 = resample_linear(wav, audio["sampling_rate"], 16000)
    wav16 = torch.nn.functional.pad(wav16, (0, -wav16.shape[-1] % 640))
    with torch.inference_mode():
        z = st.encode_fsq_values(extractor.tok_params, extractor.st_cfg, whisper_log_mel(wav16))
        v = st.fsq_values(z, extractor.st_cfg.fsq_levels)[0].numpy()
    dist = np.abs(np.abs(v - np.floor(v)) - 0.5)
    return [dict(position=int(i), card=int(card[i]), cpu=int(cpu[i]),
                 distance=float(dist[i].min())) for i in diff]


def drive_preprocess(engine, frontend, da, mg, card):
    """Phase 5o: the preprocessing pipeline on the card through the data
    route, each stage against the CPU, the models' quality bars, and a
    route-started flow trainer on the merged dataset (see the module
    docstring). Returns (record, the phase's launches of both kernels)."""
    import logging
    import shutil
    import tempfile

    import torch

    from flowmirror_hydravox_tpu_torch.preprocess import (extract_tokens, merge, resample,
                                                          transcribe, vad)
    from flowmirror_hydravox_tpu_torch.preprocess.asr_model import NativeASR, token_error_rate
    from flowmirror_hydravox_tpu_torch.runtime.training_manager import TrainingManager
    from flowmirror_hydravox_tpu_torch.runtime.training_plots import parse_training_logs
    from flowmirror_hydravox_tpu_torch.tools import eval_vad
    from flowmirror_hydravox_tpu_torch.train.synth_speech import synth_utterance_with_segments
    from flowmirror_hydravox_tpu_torch.utils import hf_dataset
    from flowmirror_hydravox_tpu_torch.utils.wavio import encode_wav

    root_log = logging.getLogger()  # the stages' own INFO lines, in this process: not printed
    saved_level = root_log.level
    if not root_log.handlers:
        logging.basicConfig(level=logging.WARNING)
    root_log.setLevel(logging.WARNING)
    dev = torch.device(PRE_DEVICE)
    da.launch_count = mg.launch_count = 0
    rec = {"card": card}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="hydravox_pre_"))
    raw = ROOT / "chiprun_out" / "preprocess_raw"
    shutil.rmtree(raw, ignore_errors=True)
    rng = np.random.default_rng(PRE_SEED)
    for i in range(PRE_CLIPS):
        sub = raw / ("a" if i < PRE_CLIPS // 2 else "b")
        sub.mkdir(parents=True, exist_ok=True)
        wav, _ = synth_utterance_with_segments(300 + i, 30_000 + i,
                                               float(rng.uniform(*PRE_SECONDS)), seed=1)
        (sub / f"clip{i}.wav").write_bytes(encode_wav(wav, 16000))
    raw_tree = wav_tree(raw)
    rec["corpus"] = dict(clips=len(raw_tree), audio_s=audio_seconds(raw_tree))
    d = {k: tmp / k for k in ("s1", "s2", "s3a", "s3b", "s4a", "s4b", "merged", "cpu", "card")}
    manager = TrainingManager(device=PRE_DEVICE)
    servers = start_servers(engine, frontend, window={"training": manager})
    url = servers["window"][2]
    stage_s = {}
    try:
        # 5o.1: the five stages through /api/v1/data/run, the jobs on the card
        stage_s["1"], (log1,) = data_stage(url, [{"stage": "1", "input_dir": str(raw),
                                                  "output_dir": str(d["s1"]),
                                                  "sample_rate": 24000}], "stage 1")
        ffmpeg = "resampling" not in log1
        if not (ffmpeg and f"ffmpeg converted {PRE_CLIPS}/{PRE_CLIPS}" in log1) and \
                f"resampling {PRE_CLIPS} files on device {PRE_DEVICE}" not in log1:
            fail(f"5o stage 1: the log names no resampling on {PRE_DEVICE}:\n{log1[-2000:]}")
        stage_s["2"], (log2,) = data_stage(url, [{"stage": "2", "input_dir": str(d["s1"]),
                                                  "output_dir": str(d["s2"]),
                                                  "vad_model": "native"}], "stage 2")
        s2_tree = wav_tree(d["s2"])
        sidecars = 0
        for k in s2_tree:
            if int(pathlib.Path(k).stem.split("_")[0][4:]) in PRE_SIDECAR:
                (d["s2"] / k).with_suffix(".txt").write_text(f"sidecar transcript of {k}")
                sidecars += 1
        stage_s["3"], logs3 = data_stage(url, [
            {"stage": "3", "input_dir": str(d["s2"] / sub), "output_dir": str(d[f"s3{sub}"]),
             "asr_module": "native", "no_filename_fallback": True} for sub in "ab"], "stage 3")
        shutil.rmtree(PRE_S3_KEEP, ignore_errors=True)
        shutil.copytree(d["s3a"], PRE_S3_KEEP)  # phase 5p's train_asr --dataset
        stage_s["4"], logs4 = data_stage(url, [
            {"stage": "4", "input_dir": str(d[f"s3{sub}"]), "output_dir": str(d[f"s4{sub}"])}
            for sub in "ab"], "stage 4")
        stage_s["5"], _ = data_stage(url, [{"stage": "5",
                                            "input_dir": f"{d['s4a']},{d['s4b']}",
                                            "output_dir": str(d["merged"])}], "stage 5")
        for what, log, line in (("stage 2", log2, "native VAD on device"),
                                *((f"stage 3{s}", l, "native ASR on device")
                                  for s, l in zip("ab", logs3)),
                                *((f"stage 4{s}", l, "rows on device")
                                  for s, l in zip("ab", logs4))):
            if f"{line} {PRE_DEVICE}" not in log:
                fail(f"5o {what}: the log does not name the {PRE_DEVICE} device:\n{log[-2000:]}")
        rec["stages"] = dict(seconds=stage_s, stage1_ffmpeg=ffmpeg, sidecars=sidecars,
                             segments=len(s2_tree))
        print("5o stages", json.dumps(rec["stages"]), flush=True)

        # 5o.2: each stage again in this process, on the CPU and on the card
        s1_tree = wav_tree(d["s1"])
        cmp = {}
        resample.main(["--input_dir", str(raw), "--output_dir", str(d["cpu"] / "s1"),
                       "--device", "cpu"])
        cmp["stage1_steps"] = same_wavs(s1_tree, wav_tree(d["cpu"] / "s1"), "stage 1")
        for k in raw_tree:  # the card's resampling itself, whatever converted stage 1
            for dv, out in ((PRE_DEVICE, d["card"]), ("cpu", d["cpu"])):
                resample.resample_wav(str(raw / k), str(out / "r1" / k), 24000, torch.device(dv))
        cmp["resample_steps"] = same_wavs(wav_tree(d["card"] / "r1"), wav_tree(d["cpu"] / "r1"),
                                          "stage 1 resampling")
        timed = {}
        torch.cuda.reset_peak_memory_stats(dev)
        for where, dv in (("card", PRE_DEVICE), ("cpu", "cpu")):
            out = d[where]
            t0 = time.time()
            vad.main(["--input_dir", str(d["s1"]), "--output_dir", str(out / "s2"),
                      "--model", "native", "--device", dv])
            timed[f"stage2_{where}_s"] = time.time() - t0
            t0 = time.time()
            for sub in "ab":
                transcribe.main(["--input_dir", str(d["s2"] / sub), "--output_dir",
                                 str(out / f"s3{sub}"), "--asr_module", "native",
                                 "--no_filename_fallback", "--device", dv])
            timed[f"stage3_{where}_s"] = time.time() - t0
            t0 = time.time()
            for sub in "ab":
                extract_tokens.main(["--input_dir", str(d[f"s3{sub}"]), "--output_dir",
                                     str(out / f"s4{sub}"), "--device", dv])
            timed[f"stage4_{where}_s"] = time.time() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        merge.main(["--input_dir", f"{d['s4a']},{d['s4b']}", "--output_dir",
                    str(d["cpu"] / "merged")])

        # stage 2: the same segments, unless a frame lies on the threshold
        vad_err, near, near_at = vad_card_cpu(s1_tree)
        s2_cpu = wav_tree(d["cpu"] / "s2")
        if vad_err > PRE_VAD_ATOL:
            fail(f"5o stage 2: VAD probabilities {vad_err} apart, card against CPU")
        differing = {pathlib.Path(k).stem.rsplit("_", 1)[0]
                     for k in set(s2_cpu) | set(s2_tree)
                     if k not in s2_cpu or k not in s2_tree
                     or not np.array_equal(s2_cpu[k][0], s2_tree[k][0])}
        if not all(near_at[k] for k in s1_tree if pathlib.Path(k).stem in differing):
            fail(f"5o stage 2: segments differ on the card in {sorted(differing)} with no "
                 f"frame within {PRE_VAD_ATOL} of 0.5")
        cmp.update(vad_max_abs_err=vad_err, vad_frames_near_half=near,
                   stage2_differing_clips=sorted(differing))
        # stage 3: the same texts and audio
        audio_s = {"stage2": audio_seconds(s1_tree), "stage3": audio_seconds(s2_tree),
                   "stage4": 0.0}
        for sub in "ab":
            route = hf_dataset.load_from_disk(str(d[f"s3{sub}"]))
            audio_s["stage4"] += sum(len(r["audio"]["array"]) / r["audio"]["sampling_rate"]
                                     for r in route)
            cpu = hf_dataset.load_from_disk(str(d["cpu"] / f"s3{sub}"))
            if list(route) != list(cpu):
                fail(f"5o stage 3{sub}: rows differ, card {route['text']} CPU {cpu['text']}")
        # stage 4: tokens under 5d's margin rule, mel and embedding within 5d's tolerances
        cpu_extractor = extract_tokens.Extractor(device="cpu")
        flips, mel_err, mel_quiet_err, emb_err, rows4 = [], 0.0, 0.0, 0.0, 0
        for sub in "ab":
            route = hf_dataset.load_from_disk(str(d[f"s4{sub}"]))
            cpu = hf_dataset.load_from_disk(str(d["cpu"] / f"s4{sub}"))
            if len(route) != len(cpu) or route.features != cpu.features:
                fail(f"5o stage 4{sub}: {len(route)} rows on the card, {len(cpu)} on the CPU")
            for r_card, r_cpu in zip(route, cpu):
                rows4 += 1
                flips += token_flips(cpu_extractor, r_cpu["audio"], r_card["speech_token"],
                                     r_cpu["speech_token"])
                mel_cpu = np.asarray(r_cpu["mel"])
                err = np.abs(np.asarray(r_card["mel"]) - mel_cpu)
                loud = mel_cpu >= mel_cpu.max() - PRE_MEL_RANGE
                mel_err = max(mel_err, float(err[loud].max()))
                mel_quiet_err = max(mel_quiet_err, float(err.max()))
                emb_err = max(emb_err, float(np.abs(np.asarray(r_card["embedding"])
                                                    - np.asarray(r_cpu["embedding"])).max()))
        if any(f["distance"] > FLIP_DISTANCE for f in flips) or mel_err > MEL_ATOL or \
                mel_quiet_err > PRE_MEL_QUIET_ATOL or emb_err > EMB_ATOL:
            fail(f"5o stage 4: the card disagrees with the CPU: flips {flips}, mel {mel_err} "
                 f"(all bins {mel_quiet_err}), embedding {emb_err}")
        # stage 5: the same rows in the same order, the same features
        merged = hf_dataset.load_from_disk(str(d["merged"]))
        merged_cpu = hf_dataset.load_from_disk(str(d["cpu"] / "merged"))
        if len(merged) != rows4 or merged["text"] != merged_cpu["text"] or \
                merged.features != merged_cpu.features:
            fail(f"5o stage 5: {len(merged)} rows, {rows4} from stage 4; texts "
                 f"{merged['text']} against {merged_cpu['text']}")
        cmp.update(token_flips=flips, mel_max_abs_err=mel_err,
                   mel_max_abs_err_all_bins=mel_quiet_err, emb_max_abs_err=emb_err, rows=rows4)
        rec["card_vs_cpu"] = cmp
        print("5o card vs CPU", json.dumps(cmp), flush=True)
        rec["in_process"] = dict(
            audio_s=audio_s, peak_gb=peak / 1e9, **timed,
            **{f"{st}_{where}_audio_s_per_s": audio_s[st] / timed[f"{st}_{where}_s"]
               for st in ("stage2", "stage3", "stage4") for where in ("card", "cpu")})
        print("5o in-process", json.dumps(rec["in_process"]), flush=True)

        # 5o.3: the shipped models' quality bars, on the card
        vad_f1 = eval_vad.evaluate(**PRE_VAD_EVAL, device=PRE_DEVICE)
        f1 = {cond: {det: v[2] for det, v in dets.items()} for cond, dets in vad_f1.items()}
        if not (all(f1[c]["native"] > 0.8 and f1[c]["native"] > f1[c]["energy"] + 0.2
                    for c in ("white", "hum")) and f1["clean"]["native"] > 0.85):
            fail(f"5o: VAD F1 below the bars: {f1}")
        asr = NativeASR(device=PRE_DEVICE)
        asr(synth_utterance_with_segments(299, 9_999, 4.0, seed=1)[0], 16000)  # first use
        ters, asr_s = [], 0.0
        for c in range(PRE_ASR_CLIPS):
            wav, segs = synth_utterance_with_segments(300 + c, 10_000 + c, 4.0, seed=1)
            t0 = time.time()
            hyp = asr(wav, 16000)
            asr_s += time.time() - t0
            ters.append(token_error_rate(segs, list(hyp)))
        if not float(np.mean(ters)) < PRE_TER:
            fail(f"5o: NativeASR's TER {ters} on the card, mean not below {PRE_TER}")
        rec["quality"] = dict(vad_f1=f1, asr_ters=ters, asr_mean_ter=float(np.mean(ters)),
                              asr_ms_per_clip=asr_s / PRE_ASR_CLIPS * 1e3)
        print("5o quality", json.dumps(rec["quality"]), flush=True)

        # 5o.4: a route-started flow trainer on the merged dataset
        t0 = time.time()
        code, body = http_status(url, "/api/v1/training/start", {
            "model_type": "flow", "train_data": str(d["merged"]),
            "output_dir": str(tmp / "flow"), **PRE_FLOW})
        if code != 200:
            fail(f"5o: /api/v1/training/start {code} {body}")
        status, log = poll_job(url, body["data"]["training_id"],
                               lambda s, _: s["status"] != "running", "5o train_flow",
                               PRE_JOB_LIMIT_S)
        if status["status"] != "completed" or status["returncode"] != 0 or \
                f"training on device {PRE_DEVICE}" not in log:
            fail(f"5o: train_flow ended {status['status']} rc {status['returncode']}:\n"
                 f"{log[-3000:]}")
        points = parse_training_logs(log)
        if points["steps"] != list(range(1, PRE_FLOW["max_steps"] + 1)) or \
                not np.isfinite(points["losses"]).all():
            fail(f"5o: train_flow's step losses {points['steps']} {points['losses']}")
        rec["train_flow"] = dict(start_to_completed_s=time.time() - t0, losses=points["losses"],
                                 rows=len(merged))
        print("5o train_flow", json.dumps(rec["train_flow"]), flush=True)
    finally:
        manager.stop_all()
        stop_servers(servers)
        shutil.rmtree(tmp, ignore_errors=True)
        root_log.setLevel(saved_level)
    launched = (da.launch_count, mg.launch_count)
    if launched != (0, 0):
        fail(f"5o launched the kernels {launched} times; nothing on its path runs them")
    return rec, launched


# phase 5p: frontend-extractor, VAD and ASR training
EXT_DEVICE = "cuda"  # the card (a CPU rehearsal sets "cpu")
EXT_SEED = 47
EXT_FBANK_ATOL = 1e-3  # kaldi_fbank (log power), card against the CPU, within 60 dB of the loudest
EXT_FBANK_QUIET_ATOL = 1e-2  # every bin of the voiced clips (5o's mel rule)
# the speaker clips' pauses hold bins far below the loudest, where the log power
# reads the FFTs' f32 rounding (tests/test_torch_train_frontend.py: up to ~0.2
# apart 120 dB down, CPU against JAX): there, per 20 dB band, printed
EXT_FBANK_BANDS_DB = (20, 40, 60, 80, 100, 120)
EXT_LOSS_REL = 1e-5  # one f32 step, card against the CPU
EXT_MOMENT_TOL = 1e-4  # Adam's moments, of each leaf's largest
# a ReLU input that the card and the CPU put on two sides of 0 must lie within
# EXT_FLIP_Z of its layer's largest |input| (their f32 rounding); the moments of
# the ReLU stack's leaves, whose gradients pass through it, are then held to
# EXT_FLIP_TOL (the card's VAD step read 8.3e-4 across 10 such flips, on an
# H100 with TF32 off)
EXT_FLIP_Z = 1e-4
EXT_FLIP_TOL = 3e-3
EXT_CROSS = {"tokenizer": (4, 4.0), "speaker": (8, 3.0), "vad": (32, 4.0), "asr": (8, 4.0)}
EXT_TIMED_STEPS = 12  # the in-process runs; steps 3-12 are timed
EXT_TRACED_STEPS = 3  # and the next ones traced
EXT_POOLS = {"vad": dict(speech_pool=64, noise_pool=8), "asr": dict(pool=64, noise_pool=4)}
EXT_CLI_STEPS = 40
EXT_DATASET_STEPS = 4
EXT_JOB_LIMIT_S = 600
EXT_SERVE_SEED = 4747
EXT_ASR_EVAL = dict(n_clips=6)
EXT_CLIS = {  # name: (module, flags); each adds --output_dir, --device, --max_steps, --logging_steps 1
    "tokenizer": ("train_frontend", ["--model", "tokenizer", "--preset", "shipped",
                                     "--synthetic_speech", "--corpus_utts", "64",
                                     "--n_speakers", "8", "--batch_size", "32",
                                     "--seconds", "4"]),
    "speaker": ("train_frontend", ["--model", "speaker", "--preset", "shipped",
                                   "--synthetic_speech", "--corpus_utts", "64", "--n_speakers",
                                   "8", "--batch_size", "64", "--seconds", "3"]),
    "vad": ("train_vad", ["--speech_pool", str(EXT_POOLS["vad"]["speech_pool"]),
                          "--noise_pool", str(EXT_POOLS["vad"]["noise_pool"])]),
    "asr": ("train_asr", ["--pool", str(EXT_POOLS["asr"]["pool"]),
                          "--noise_pool", str(EXT_POOLS["asr"]["noise_pool"])]),
}
EXT_LOSS_LINE = {"train_frontend": r"step (\d+) \{'loss': ([^,}]+)",
                 "train_vad": r"step (\d+) loss (\S+) acc", "train_asr": r"step (\d+) loss (\S+) emit"}


class ReluInputs:
    """While entered, keeps a CPU copy of the input of every torch.relu and
    torch.nn.functional.relu call (the VAD's and the speaker encoder's)."""

    def __enter__(self):
        import torch

        self.inputs = []
        self.saved = torch.relu, torch.nn.functional.relu

        def recorded(fn):
            def relu(x, *args, **kwargs):
                self.inputs.append(x.detach().float().cpu())
                return fn(x, *args, **kwargs)

            return relu

        torch.relu, torch.nn.functional.relu = (recorded(f) for f in self.saved)
        return self

    def __exit__(self, *exc):
        import torch

        torch.relu, torch.nn.functional.relu = self.saved


def relu_flips(card: list, cpu: list) -> list:
    """Per ReLU call, the |CPU input| / its layer's largest at each element
    the card and the CPU put on two sides of 0."""
    out = []
    for a, b in zip(card, cpu, strict=True):
        flipped = (a > 0) != (b > 0)
        out.append([float(v) for v in (b[flipped].abs() / b.abs().max()).tolist()])
    return out


def moment_errs(opt_a, opt_b) -> dict:
    """{leaf: largest over mu and nu of max |a - b| / max |b|}."""
    out = {}
    for name in ("mu", "nu"):
        for k, mb in opt_b[name].items():
            scale = float(mb.abs().max())
            err = float((opt_a[name][k].cpu() - mb).abs().max()) / scale if scale > 0 else 0.0
            out[k] = max(out.get(k, 0.0), err)
    return out


def ext_clips(b: int, seconds: float, seed: int) -> np.ndarray:
    """(b, 16 kHz samples) f32 synthetic utterances of 8 speakers, pauses
    included: the frontend models' cross-device batch."""
    from flowmirror_hydravox_tpu_torch.train.synth_speech import synth_utterance

    return np.stack([synth_utterance(i % 8, 50_000 + i, seconds, seed=seed)
                     for i in range(b)]).astype(np.float32)


def ext_models(seed: int):
    """{model: (tree on the CPU, loss_fn, optimizer, numpy batch, the
    leaves behind its ReLU stack)} at full width, each tree from a torch
    generator seeded with `seed`, each optimizer its trainer's."""
    import torch

    from flowmirror_hydravox_tpu_torch.preprocess import asr_model, vad_model
    from flowmirror_hydravox_tpu_torch.train import steps, train_asr, train_frontend, train_vad
    from flowmirror_hydravox_tpu_torch.utils.audio import kaldi_fbank
    from flowmirror_hydravox_tpu_torch.train.synth_speech import FRIC_SYMBOLS, VOWEL_SYMBOLS

    def gen():
        return torch.Generator().manual_seed(seed)

    out = {}
    for model in ("tokenizer", "speaker"):
        args = train_frontend.parse_args(["--model", model, "--output_dir", "unused",
                                          "--seed", str(seed)])
        cfg = train_frontend.model_config(args)
        b, sec = EXT_CROSS[model]
        batch, fn = {"wavs": ext_clips(b, sec, seed)}, train_frontend.loss_fn(model, cfg)
        if model == "speaker":
            # both devices from the CPU's fbank: 5p.1 holds kaldi_fbank itself on
            # these clips, and its differences in their near-silent bins (the FFTs'
            # rounding, printed per band there) would set this comparison
            batch = {"feats": kaldi_fbank(torch.from_numpy(batch["wavs"])).numpy(),
                     "labels": (np.arange(b) % args.n_speakers).astype(np.int32)}
            def fn(p, bt, cfg=cfg):
                return train_frontend.speaker_feature_loss(p, cfg, bt["feats"], bt["labels"])
        opt = steps.Optimizer(steps.OptimConfig(learning_rate=args.learning_rate,
                                                warmup_steps=args.warmup_steps,
                                                total_steps=args.max_steps))
        out[model] = (train_frontend.init_tree(args, cfg, "cpu"), fn, opt, batch,
                      {"speaker": ("spk.proj", "classifier")}.get(model, ()))
    vcfg = vad_model.VADModelConfig()
    b, sec = EXT_CROSS["vad"]
    wavs, labels = next(train_vad.mixture_batches(b, sec, seed, **EXT_POOLS["vad"]))

    def vad_loss(p, batch):
        loss, acc = vad_model.bce_loss(p, vcfg, batch["wavs"], batch["labels"])
        return loss, {"acc": acc}

    out["vad"] = (vad_model.init_params(vcfg, gen()), vad_loss, train_vad.optimizer(1e-3, 2000),
                  {"wavs": wavs, "labels": labels}, ("out.w", "out.b"))
    vocab = list(VOWEL_SYMBOLS) + list(FRIC_SYMBOLS)
    acfg = asr_model.ASRModelConfig(vocab_size=len(vocab) + 1)
    b, sec = EXT_CROSS["asr"]
    wavs, wav_len, labels, label_len = next(train_asr.synthetic_batches(
        b, sec, seed, vocab, **EXT_POOLS["asr"]))

    def asr_loss(p, batch):
        loss, emit = asr_model.ctc_loss(p, acfg, batch["wavs"], batch["wav_len"],
                                        batch["labels"], batch["label_len"])
        return loss, {"emit_frac": emit}

    out["asr"] = (asr_model.init_params(acfg, gen()), asr_loss, train_asr.optimizer(2e-3, 3000),
                  {"wavs": wavs, "wav_len": wav_len, "labels": labels,
                   "label_len": label_len}, ())
    return out


def ext_fbank(dev) -> dict:
    """5p.1: kaldi_fbank on `dev` against the CPU (see the module
    docstring)."""
    import torch

    from flowmirror_hydravox_tpu_torch.utils.audio import kaldi_fbank

    def both(wavs):
        on_dev = kaldi_fbank(torch.from_numpy(wavs).to(dev)).cpu().numpy()
        on_cpu = kaldi_fbank(torch.from_numpy(wavs)).numpy()
        if not np.isfinite(on_dev).all() or on_dev.shape != on_cpu.shape:
            fail(f"5p: kaldi_fbank on the card: shape {on_dev.shape}, finite "
                 f"{np.isfinite(on_dev).all()}")
        # each bin's depth below its clip's loudest, dB of power
        depth = (on_cpu.max(axis=(1, 2), keepdims=True) - on_cpu) * 10 / np.log(10)
        return np.abs(on_dev - on_cpu), depth

    err, depth = both(np.stack([voiced(16000, 3.0, EXT_SEED + i) for i in range(4)]))
    out = {"voiced": dict(within_60dB=float(err[depth <= 60].max()),
                          all_bins=float(err.max()))}
    b, sec = EXT_CROSS["speaker"]
    err, depth = both(ext_clips(b, sec, EXT_SEED))
    bands, lo = {}, 0
    for hi in (*EXT_FBANK_BANDS_DB, np.inf):
        inside = (depth >= lo) & (depth < hi)
        bands[f"{lo}-{hi}dB"] = dict(bins=int(inside.sum()), max_abs_err=float(
            err[inside].max()) if inside.any() else None)
        lo = hi
    out["speaker_clips"] = dict(within_60dB=float(err[depth <= 60].max()),
                                all_bins=float(err.max()), bands=bands)
    print("5p kaldi_fbank card vs CPU", json.dumps(out), flush=True)
    if max(out["voiced"]["within_60dB"], out["speaker_clips"]["within_60dB"]) > EXT_FBANK_ATOL \
            or out["voiced"]["all_bins"] > EXT_FBANK_QUIET_ATOL:
        fail(f"5p: kaldi_fbank on the card {out} from the CPU's")
    return out


def ext_step(tree, fn, opt, batch: dict, dev) -> tuple:
    """(state, metrics, the ReLU inputs) of one step of `fn` from `tree`
    (updated in place) on `dev`."""
    from flowmirror_hydravox_tpu_torch.train import steps

    state = steps.init_state(tree, opt)
    with ReluInputs() as relu:
        state, metrics = steps.loss_train_step(state, steps.batch_to(batch, dev), fn, opt)
    return state, metrics, relu.inputs


def ext_compare(card: tuple, cpu: tuple, past_relu) -> tuple:
    """(record, {what: reading} over its 5p.2 gate) of a card step against
    the CPU's, each an `ext_step` result."""
    (card_state, m_card, card_relu), (cpu_state, m_cpu, cpu_relu) = card, cpu
    flips = relu_flips(card_relu, cpu_relu)
    errs = moment_errs(card_state.opt_state, cpu_state.opt_state)
    n_flips = sum(len(f) for f in flips)
    rec = dict(loss=float(m_card["loss"]),
               loss_rel=abs(float(m_card["loss"]) - float(m_cpu["loss"]))
               / abs(float(m_cpu["loss"])),
               moments_err=max(errs.values()),
               moments_err_past_relu=max([errs[k] for k in past_relu], default=None),
               relu_flips=n_flips, flip_z=max([max(f) for f in flips if f], default=None))
    tol = {k: EXT_FLIP_TOL if n_flips and k not in past_relu else EXT_MOMENT_TOL for k in errs}
    bad = {k: e for k, e in errs.items() if e > tol[k]}
    if rec["loss_rel"] > EXT_LOSS_REL:
        bad["loss_rel"] = rec["loss_rel"]
    if n_flips and rec["flip_z"] > EXT_FLIP_Z:
        bad["flip_z"] = rec["flip_z"]
    return rec, bad


def ext_cross_device(dev) -> dict:
    """5p.2: one f32 step of each model on `dev` and on the CPU, then on
    `dev` with TF32 on (see the module docstring)."""
    import torch

    from flowmirror_hydravox_tpu_torch.train import steps

    out = {}
    for model, (tree, fn, opt, batch, past_relu) in ext_models(EXT_SEED).items():
        card_tree, tf32_tree = tree_to_device(tree, dev), tree_to_device(tree, dev)
        params = sum(p.numel() for _, p in steps.tree_leaves(tree))
        cpu = ext_step(tree, fn, opt, batch, "cpu")
        rec, bad = ext_compare(ext_step(card_tree, fn, opt, batch, dev), cpu, past_relu)
        rec.update(batch={k: list(v.shape) for k, v in batch.items()}, params=params)
        print(f"5p card vs CPU {model}", json.dumps(rec), flush=True)
        if bad:
            fail(f"5p: the card's {model} step differs from the CPU's: {rec}, over the gate {bad}")
        if dev.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            try:
                tf32, tf32_bad = ext_compare(ext_step(tf32_tree, fn, opt, batch, dev), cpu,
                                             past_relu)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            rec["tf32"] = dict(tf32, over_the_gates=tf32_bad)
            print(f"5p card with TF32 vs CPU {model}", json.dumps(rec["tf32"]), flush=True)
        out[model] = rec
    return out


class ExtStepTimer:
    """A trainer's `on_step`: synchronises the card and records the wall
    time (the first one's from the timer's creation: the pool or corpus
    build, the first batch and the first step) and loss of each of the first
    EXT_TIMED_STEPS steps; then traces the next EXT_TRACED_STEPS under
    torch.profiler, without a sync or a loss read between them (`trace`:
    their per-step `bench_train.trace_summary`)."""

    def __init__(self, dev):
        self.dev, self.secs, self.losses, self.trace = dev, [], [], None
        self.steps, self.prof = 0, None
        self.t = time.perf_counter()

    def sync(self):
        import torch

        if self.dev.type == "cuda":
            torch.cuda.synchronize()

    def __call__(self, state, metrics):
        import torch
        from torch.profiler import ProfilerActivity

        from flowmirror_hydravox_tpu_torch.tools.bench_train import STEP_RANGES, trace_summary

        self.steps += 1
        if self.steps <= EXT_TIMED_STEPS:
            self.sync()
            now = time.perf_counter()
            self.secs.append(now - self.t)
            self.t = now
            loss = float(metrics["loss"])
            if not np.isfinite(loss):
                fail(f"5p: step {state.step} loss {loss}")
            self.losses.append(loss)
            if self.steps == EXT_TIMED_STEPS:
                activities = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if self.dev.type == "cuda" else [])
                self.prof = torch.profiler.profile(activities=activities)
                self.prof.start()
                self.t = time.perf_counter()
        elif self.steps == EXT_TIMED_STEPS + EXT_TRACED_STEPS:
            self.sync()
            wall = time.perf_counter() - self.t
            self.prof.stop()
            self.trace = trace_summary(self.prof, wall, EXT_TRACED_STEPS, top=5,
                                       ranges=STEP_RANGES)


def ext_in_process(dev, out_dir: pathlib.Path, cfg, tokenizer) -> dict:
    """5p.6 and 5p.4: each trainer's main in this process for
    EXT_TIMED_STEPS + EXT_TRACED_STEPS steps at the CLI's shapes (the VAD and
    ASR pools cut to EXT_POOLS), timed and traced (`ExtStepTimer`); its files
    loaded by the port's loaders on `dev` equal to the trained tree. Returns
    {model: figures}."""
    import torch

    from flowmirror_hydravox_tpu_torch.frontend.frontend import Frontend
    from flowmirror_hydravox_tpu_torch.params import flatten_params
    from flowmirror_hydravox_tpu_torch.preprocess.asr_model import NativeASR
    from flowmirror_hydravox_tpu_torch.preprocess.vad_model import NativeVAD
    from flowmirror_hydravox_tpu_torch.train import train_asr, train_frontend, train_vad

    modules = {"train_frontend": train_frontend, "train_vad": train_vad, "train_asr": train_asr}
    out, states = {}, {}
    for model, (module, flags) in EXT_CLIS.items():
        timer = ExtStepTimer(dev)
        reset_peak(dev)
        before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
        argv = [*flags, "--output_dir", str(out_dir / model), "--device", dev.type,
                "--max_steps", str(EXT_TIMED_STEPS + EXT_TRACED_STEPS),
                "--logging_steps", "100"]
        states[model] = modules[module].main(argv, on_step=timer)
        args = modules[module].parse_args(argv)
        step_s = statistics.median(timer.secs[2:])
        audio_s = args.batch_size * args.seconds
        out[model] = dict(step_ms=step_s * 1e3,
                          step_ms_range=[min(timer.secs[2:]) * 1e3,
                                         max(timer.secs[2:]) * 1e3],
                          audio_s_per_s=audio_s / step_s, batch=args.batch_size,
                          seconds=args.seconds, to_step1_s=timer.secs[0],
                          peak_gb=peak_bytes(dev) / 1e9, before_gb=before / 1e9,
                          losses=timer.losses, trace=timer.trace)
        if timer.trace["device_busy_ms"] is not None:
            # the profiler slows the host: the traced busy time over the untraced step
            out[model]["device_busy_share"] = timer.trace["device_busy_ms"] / out[model][
                "step_ms"]
        print(f"5p in-process {model}", json.dumps({k: v for k, v in out[model].items()
                                                    if k not in ("losses", "trace")}),
              flush=True)
        print(f"5p trace {model}", json.dumps(timer.trace), flush=True)
        if dev.type == "cuda" and timer.trace["device_busy_ms"] is None:
            fail(f"5p: the trace of {model}'s steps saw no device activity")

    # 5p.4: the saved files through the port's loaders, on the device
    def same(got, trained, what):
        got = flatten_params(got)
        want = {k: v.detach().half().float() for k, v in flatten_params(trained).items()}
        if set(got) != set(want) or not all(torch.equal(got[k], want[k].to(got[k].device))
                                            for k in want):
            fail(f"5p: {what} does not load equal to the trained tree (fp16)")

    env = {f"HYDRAVOX_{m.upper()}_NPZ": str(out_dir / m / f"{m}.npz")
           for m in ("tokenizer", "speaker")}
    with patched_env(env):
        fe = Frontend(cfg, tokenizer=tokenizer, device=dev)
    same(fe.tokenizer_params, states["tokenizer"].params["enc"], "tokenizer.npz (Frontend)")
    same(fe.speaker_params, states["speaker"].params["spk"], "speaker.npz (Frontend)")
    if fe.st_cfg.dim != 256 or fe.spk_cfg.dim != 256:
        fail(f"5p: the Frontend read configs {fe.st_cfg} {fe.spk_cfg} from the sidecars")
    same(NativeVAD(str(out_dir / "vad" / "vad.npz"), device=dev).params,
         states["vad"].params, "vad.npz (NativeVAD)")
    same(NativeASR(str(out_dir / "asr" / "asr.npz"), device=dev).params,
         states["asr"].params, "asr.npz (NativeASR)")
    return out


class Background:
    """`fn(*args, stop)` on a thread of its own, for work that launches no
    kernel in this process (subprocesses and their HTTP clients), so that
    it runs beside a phase: `result()` joins it and fails here if it
    failed (fail() has printed why); `stop_and_join()` sets `stop`, which
    `fn` polls, and waits for it to clean up."""

    def __init__(self, fn, *args):
        self.stop, self.out, self.error = threading.Event(), None, None
        self.t0, self.wall_s = time.time(), None
        self.thread = threading.Thread(target=self._run, args=(fn, args), daemon=True)
        self.thread.start()

    def _run(self, fn, args):
        try:
            self.out = fn(*args, self.stop)
        except BaseException as e:  # fail() raises SystemExit after printing
            self.error = e
        self.wall_s = time.time() - self.t0

    def result(self):
        self.thread.join()
        if isinstance(self.error, SystemExit):
            sys.exit(self.error.code)
        if self.error is not None:
            raise self.error
        return self.out

    def stop_and_join(self):
        self.stop.set()
        self.thread.join()


def ext_cli(module: str, flags: list, out_dir: pathlib.Path, dev, steps: int):
    """The trainer `module` as a subprocess on `dev`: (Popen, log path)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    log = out_dir / "train.log"
    cmd = [sys.executable, "-m", f"flowmirror_hydravox_tpu_torch.train.{module}", *flags,
           "--output_dir", str(out_dir), "--device", dev.type, "--max_steps", str(steps),
           "--logging_steps", "1"]
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    with open(log, "w") as f:
        return subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=f, stderr=subprocess.STDOUT), log


def ext_losses(module: str, log: str) -> dict:
    """{step: loss} of a trainer's log lines."""
    return {int(m.group(1)): float(m.group(2))
            for m in re.finditer(EXT_LOSS_LINE[module], log)}


def ext_clis(dev, out_dir: pathlib.Path, stop: threading.Event) -> dict:
    """5p.3: the four CLIs and train_asr --dataset as subprocesses at once
    (see the module docstring), killed if `stop` is set first. Returns
    {run: figures}."""
    runs = {name: (module, flags, EXT_CLI_STEPS) for name, (module, flags) in EXT_CLIS.items()}
    runs["asr_dataset"] = ("train_asr", ["--dataset", str(PRE_S3_KEEP), "--batch_size", "8",
                                         "--seconds", "12.5"], EXT_DATASET_STEPS)
    if not PRE_S3_KEEP.is_dir():
        fail(f"5p: no stage-3 dataset at {PRE_S3_KEEP} (phase 5o keeps it)")
    procs, ended, out = {}, {}, {}
    t0 = time.time()
    try:
        for name, (module, flags, steps) in runs.items():
            procs[name] = (*ext_cli(module, flags, out_dir / name, dev, steps), time.time())
        while len(ended) < len(procs):  # each one's wall from its own start to its exit
            for name, (proc, _, started) in procs.items():
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.time() - started
            if time.time() - t0 > EXT_JOB_LIMIT_S or stop.is_set():
                fail(f"5p: {sorted(set(procs) - set(ended))} still running after "
                     f"{time.time() - t0:.0f} s")
            time.sleep(0.1)
        for name, (proc, log_path, _) in procs.items():
            rc, wall = proc.returncode, ended[name]
            log = log_path.read_text()
            module, _, steps = runs[name]
            losses = ext_losses(module, log)
            if rc != 0 or f"training on device {dev.type}" not in log:
                fail(f"5p {name}: rc {rc}, log:\n{log[-3000:]}")
            if sorted(losses) != list(range(1, steps + 1)) or \
                    not np.isfinite(list(losses.values())).all():
                fail(f"5p {name}: logged losses {losses}")
            seq = [losses[i] for i in range(1, steps + 1)]
            rec = dict(wall_s=wall, losses=seq)
            if name != "asr_dataset":
                q = steps // 4
                rec.update(first_quarter=float(np.mean(seq[:q])),
                           last_quarter=float(np.mean(seq[-q:])))
                if not rec["last_quarter"] < rec["first_quarter"]:
                    fail(f"5p {name}: the loss did not fall: {seq}")
            step1 = re.search(r"step 1 .*\((\d+\.\d)s\)", log)
            rec["to_step1_s"] = float(step1.group(1)) if step1 else None
            pool = re.search(r"pool: (\d+) clips, (\d+) noise \((\d+\.\d)s\)", log)
            if pool:
                rec["pool"] = dict(clips=int(pool.group(1)), noise=int(pool.group(2)),
                                   build_s=float(pool.group(3)))
            rows = re.search(r"dataset: (\d+) usable rows, vocab (\d+)", log)
            if rows:
                rec["dataset"] = dict(rows=int(rows.group(1)), vocab=int(rows.group(2)))
            out[name] = rec
            print(f"5p cli {name}", json.dumps({k: v for k, v in rec.items() if k != "losses"}),
                  flush=True)
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["all_s"] = time.time() - t0
    return out


def drive_ext_training(engine, frontend, da, mg, card):
    """Phase 5p: frontend-extractor, VAD and ASR training on the card (see
    the module docstring). Returns (record, the served request's launches)."""
    import shutil
    import tempfile

    import torch

    from flowmirror_hydravox_tpu_torch.frontend.frontend import Frontend
    from flowmirror_hydravox_tpu_torch.tools import (eval_asr, eval_frontend_real, eval_vad,
                                                     make_demo_samples)

    dev = torch.device(EXT_DEVICE)
    da.launch_count = mg.launch_count = 0
    rec = {"card": card}

    def no_launch(what):
        if (da.launch_count, mg.launch_count) != (0, 0):
            fail(f"5p: {what} launched the kernels {(da.launch_count, mg.launch_count)} times")

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="hydravox_ext_"))
    # 5p.3: the CLIs as subprocesses, beside 5p.1, 5p.2 and 5p.6 (the whole
    # run's time limit; their in-process step times share the host's cores)
    clis = Background(ext_clis, dev, tmp / "cli")
    try:
        # 5p.1: kaldi_fbank on the card against the CPU
        rec["fbank"] = ext_fbank(dev)

        # 5p.2: one f32 step of each model, card against the CPU
        rec["card_vs_cpu"] = ext_cross_device(dev)
        no_launch("a cross-device step")

        # 5p.6 and 5p.4: each trainer in this process, timed; its files reloaded
        rec["in_process"] = ext_in_process(dev, tmp / "in_process", engine.cfg,
                                           frontend.tokenizer)
        no_launch("the in-process trainers")
        rec["clis"] = clis.result()

        # 5p.5: serve what the card trained
        demo = ROOT / "chiprun_out" / "demo_samples"
        shutil.rmtree(demo, ignore_errors=True)
        make_demo_samples.main(["--root", str(demo)])
        clip = demo / "synthetic_voices" / "speaker_a" / "speaker_a_1.wav"
        env = {f"HYDRAVOX_{m.upper()}_NPZ": str(tmp / "cli" / m / f"{m}.npz")
               for m in ("tokenizer", "speaker")}
        with patched_env(env):
            trained_fe = Frontend(engine.cfg, tokenizer=frontend.tokenizer, device=dev)
        body = {"tts_text": TRAIN_TEXT, "prompt_text": clip.with_suffix(".txt").read_text().strip(),
                "mode": "zero_shot",
                "prompt_audio_base64": base64.b64encode(clip.read_bytes()).decode(),
                "extra_params": {"inference_head_num": 2, "seed": EXT_SERVE_SEED}}
        servers = start_servers(engine, trained_fe, window={})
        try:
            with EngineCalls(engine) as calls:
                recs, launched, (samples, peak) = held_worker(
                    "5p zero-shot on the card-trained extractors", calls, da, mg,
                    engine.cfg.llm,
                    lambda: audio_of(*http_status(servers["window"][2], "/api/v1/zero-shot",
                                                  body), "5p zero-shot"),
                    [("synthesize", 1)])
        finally:
            stop_servers(servers)
        rec["served"] = dict(tokens=recs[0]["tokens"], steps=recs[0]["steps"],
                             audio_s=samples / SAMPLE_RATE, peak=peak,
                             attention_launches=launched[0], mlp_launches=launched[1],
                             predicted=list(predicted_launches(recs, engine.cfg.llm)))
        print("5p served", json.dumps(rec["served"]), flush=True)
        samples_dir = str(demo / "synthetic_voices")
        rec["eval_frontend_real"] = {
            "trained": eval_frontend_real.evaluate(samples_dir, trained_fe),
            "shipped": eval_frontend_real.evaluate(samples_dir, frontend)}
        with patched_env({"HYDRAVOX_VAD_NPZ": str(tmp / "cli" / "vad" / "vad.npz")}):
            vad_f1 = eval_vad.evaluate(**PRE_VAD_EVAL, device=dev)
        rec["eval_vad"] = {cond: {det: v[2] for det, v in dets.items()}
                           for cond, dets in vad_f1.items()}
        rec["eval_asr"] = eval_asr.evaluate(**EXT_ASR_EVAL, ckpt=str(tmp / "cli" / "asr" /
                                                                     "asr.npz"), device=dev)
        print("5p eval", json.dumps({k: rec[k] for k in ("eval_frontend_real", "eval_vad",
                                                          "eval_asr")}), flush=True)
    finally:
        clis.stop_and_join()
        shutil.rmtree(tmp, ignore_errors=True)
    return rec, launched


SERVE_FLAGS = ["--device", "cuda"]  # 5q's launcher and bench (a CPU rehearsal: cpu, --tiny)
SERVE_MAX_TOKENS = 300  # the launcher of 5q: --max-tokens, as the main engine
LAUNCHER_READY_S = 300  # the launcher's start, engine and frontend built
LOADGEN_S = 6.0  # each loadgen run's window
BENCH_ARGS = ["--window", "5", "--budget", "900"]  # tools/bench_serving.py in 5q, + SERVE_FLAGS
BENCH_LIMIT_S = 900  # the bench subprocess, start to exit
BENCH_ORDER = ["host_dispatch_rtt_ms", "ttft_under_load_http_continuous",
               "staggered_load_continuous", "staggered_capacity_continuous",
               "ttft_under_load_http", "staggered_load_window", "staggered_mode_winner",
               "service_throughput_8way"]  # the JAX tool's metric lines, in its order
BENCH_UNGATED = {"staggered_capacity_continuous"}  # meant to saturate: errors printed only
CAUSAL_SEED = 53
CAUSAL_SECONDS = 5.0
CAUSAL_TOL = 1e-4  # f32 waveform, card against the CPU (the CPU tests' bar against JAX)
CAUSAL_PREFIX_TOL = 5e-2  # a grown prefix against the whole call (tests/test_hift.py)
CAUSAL_CHUNK = 10  # mel frames per growing-prefix step
CAUSAL_VOICED_HZ = 150.0  # the voiced copy's F0 offset (voiced_hift)
CAUSAL_TIMED = 10


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_any(base, path, body=None):
    """GET (no body) or POST `body`: (status, raw bytes), error statuses
    included."""
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=900) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def launcher_up(base) -> bool:
    try:
        return http_any(base, "/health")[0] == 200
    except OSError:  # not listening yet
        return False


def ui_api_calls(html: str) -> list:
    """(path, method) of each api('/...') call of the page: POST where the
    call passes a body, as the page's api(path, body) does."""
    calls = []
    for m in re.finditer(r"api\('(/[^']*)'", html):
        depth, i, post = 1, m.end(), False
        while depth:
            depth += (html[i] in "([{") - (html[i] in ")]}")
            post |= html[i] == "," and depth == 1
            i += 1
        calls.append((m.group(1), "POST" if post else "GET"))
    return calls


def ui_sets(html: str):
    """The tabs, the I18N table's en and zh key sets and the data-i18n
    markers of a page; None where the page has no I18N table."""
    m = re.search(r"const I18N = \{\s*en: \{(.*?)\},\s*zh: \{(.*?)\}\s*\};", html, re.S)
    if not m:
        return None
    key_re = r"(?:^|[,{])\s*(\w+):"  # keys only, not colons inside strings
    return {"tabs": set(re.findall(r'data-tab="(\w+)"', html)),
            "en": set(re.findall(key_re, m.group(1), re.M)),
            "zh": set(re.findall(key_re, m.group(2), re.M)),
            "markers": set(re.findall(r'data-i18n="(\w+)"', html))}


def check_ui(base, tmp: pathlib.Path) -> dict:
    """5q.1: the page at GET /, every data-i18n marker in both languages'
    tables, /api/v1/devices, and every route the page calls answered with
    a status other than 404 (ids from the calls before)."""
    from flowmirror_hydravox_tpu_torch.utils.wavio import audio_to_base64

    with urllib.request.urlopen(base + "/", timeout=60) as r:
        ctype, html = r.headers["Content-Type"], r.read().decode("utf-8")
    if ctype != "text/html; charset=utf-8":
        fail(f"5q: GET / answered {ctype}")
    sets = ui_sets(html)
    if sets is None:
        fail("5q: the page has no I18N table")
    en, zh, markers, tabs = sets["en"], sets["zh"], sets["markers"], sets["tabs"]
    if en != zh or not markers <= en or len(tabs) != 6:
        fail(f"5q: i18n en/zh differ {en ^ zh} or markers unresolved {markers - en}, tabs {tabs}")
    code, raw = http_any(base, "/api/v1/devices")
    devices = json.loads(raw)["data"]
    if code != 200 or devices["platform"] != "gpu" or devices["device_count"] != 1:
        fail(f"5q: /api/v1/devices {code} {devices}")

    prompt = audio_to_base64(voiced(16000, 3.0, CAUSAL_SEED), 16000)
    answers = []

    def probe(path, body=None, want=None):
        code, raw = http_any(base, "/api/v1" + path, body)
        answers.append((path, "GET" if body is None else "POST", code))
        if code == 404 or (want is not None and code != want):
            fail(f"5q: {path} answered {code}: {raw[:300]!r}")
        return json.loads(raw) if raw[:1] == b"{" else raw

    probe("/speakers", want=200)
    probe("/speakers/add", {"speaker_id": "ui_probe", "audio_base64": prompt,
                            "prompt_text": ZS_PROMPT_TEXT}, want=200)
    probe("/speakers/add", {}, want=400)
    probe("/speakers/remove/ui_probe", {}, want=200)
    audio_of(200, probe("/tts", {"text": "The page sends this sentence to the card.",
                                 "speaker_id": "default"}, want=200), "5q /tts")
    listed = probe("/samples", want=200)["data"]["samples"]
    probe("/samples/load", {"path": listed[0]["path"] if listed else "../x"},
          want=200 if listed else 400)
    audio_of(200, probe("/zero-shot", {"tts_text": "The page clones this voice.",
                                       "prompt_text": ZS_PROMPT_TEXT,
                                       "prompt_audio_base64": prompt, "mode": "zero_shot"},
                        want=200), "5q /zero-shot")
    probe("/devices", want=200)
    tid = probe("/data/run", {"stage": "5", "input_dir": str(tmp / "no_dataset"),
                              "output_dir": str(tmp / "merged")}, want=200)["data"]["training_id"]
    deadline = time.time() + 120
    while probe(f"/training/status/{tid}", want=200)["data"]["status"] == "running":
        if time.time() > deadline:
            fail("5q: the probe's data job did not end within 120 s")
        time.sleep(1.0)
    probe(f"/training/plot/{tid}")
    probe(f"/training/stop/{tid}", {}, want=200)
    probe("/training/start", {}, want=400)
    probe("/models/list", want=200)
    probe("/models/delete", {"path": "../x"}, want=400)
    probe("/models/convert", {}, want=400)
    probe("/load_pt", {}, want=200)
    missing = {(p, m) for p, m in ui_api_calls(html)
               if not any(meth == m and (q == p or (p.endswith("/") and q.startswith(p)))
                          for q, meth, _ in answers)}
    if missing:
        fail(f"5q: the page calls routes this phase did not probe: {sorted(missing)}")
    rec = dict(bytes=len(html), tabs=len(tabs), i18n_keys=len(en), markers=len(markers),
               page_calls=len(ui_api_calls(html)), devices=devices,
               answers=[f"{meth} {p} {c}" for p, meth, c in answers])
    print("5q ui", json.dumps(rec), flush=True)
    return rec


def loadgen_runs(base, env, stopped) -> list:
    """5q.2: tools/loadgen.py's CLI against the launcher: closed-loop /tts,
    then Poisson /tts/stream; every request answered, and the slots'
    continuous_requests rising with each. `stopped()` fails if the run was
    stopped."""
    runs = []
    for flags in (["--mode", "tts"], ["--mode", "stream", "--arrival", "poisson", "--rate", "1"]):
        stopped()
        before = json.loads(http_any(base, "/api/v1/metrics")[1])["data"]["continuous_requests"]
        out = subprocess.run([sys.executable, "-m", "flowmirror_hydravox_tpu_torch.tools.loadgen",
                              "--url", base, "--speaker", "default", "--concurrency", "2",
                              "--duration", str(LOADGEN_S), "--timeout", "120", *flags],
                             cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            fail(f"5q: loadgen {flags} rc {out.returncode}: {out.stderr[-2000:]}")
        line = out.stdout.strip().splitlines()[-1]
        print("5q loadgen", line, flush=True)
        res = json.loads(line)
        if res["requests"] <= 0 or res["errors"] != 0 or res["continuous_requests"] <= before:
            fail(f"5q: loadgen {flags}: requests {res['requests']}, errors {res['errors']}, "
                 f"continuous_requests {before} -> {res['continuous_requests']}")
        runs.append(res)
    return runs


def check_bench(lines: list) -> dict:
    """5q.3: every scenario of tools/bench_serving.py measured, in the JAX
    order, none skipped or failed; errors 0 but in the capacity probe."""
    metrics = [ln for ln in lines if "metric" in ln]
    bad = [ln for ln in metrics if ln.get("skipped") or "error" in ln]
    if bad or [ln["metric"] for ln in metrics] != BENCH_ORDER:
        fail(f"5q: bench_serving lines {[ln['metric'] for ln in metrics]}, failed: {bad}")
    errs = {ln["metric"]: ln["errors"] for ln in metrics if "errors" in ln}
    if any(n for name, n in errs.items() if name not in BENCH_UNGATED):
        fail(f"5q: bench_serving errors {errs}")
    return {ln["metric"]: {k: v for k, v in ln.items() if k not in ("aux", "metric")}
            for ln in metrics}


def voiced_hift(tree, hz: float):
    """A HiFT tree whose F0 predictor sits near `hz`: the classifier's bias
    moved up by `hz`, so that every frame is voiced (the random tree's F0
    lies below the 10 Hz threshold, where the causal source is its noise
    alone)."""
    f0p = tree["f0_predictor"]
    cls = {**f0p["classifier"], "b": f0p["classifier"]["b"] + hz}
    return {**tree, "f0_predictor": {**f0p, "classifier": cls}}


def check_causal_hift(engine) -> dict:
    """5q.4: CausalHiFT at the served HiFT (default HiFTConfig, f32) on
    CAUSAL_SECONDS of seeded mel with seeded fixed noise, on the served tree
    and on its voiced copy (`voiced_hift`, every frame voiced, so that the
    source's sine half is in the waveform): card against the CPU, finalize
    on and off; the growing-prefix check on the card; ms per call beside
    the non-causal inference."""
    import torch

    from flowmirror_hydravox_tpu_torch.models import hift
    from flowmirror_hydravox_tpu_torch.noise import TorchNoise

    cfg, card_p, dev = engine.cfg.hift, engine.hift_params, engine.device
    t_mel = int(CAUSAL_SECONDS * cfg.sampling_rate) // cfg.upsample_scale
    mel = torch.from_numpy(np.random.default_rng(CAUSAL_SEED).standard_normal(
        (1, 80, t_mel)).astype(np.float32) * 0.5).to(dev)
    rand_ini, noise = hift.causal_noise(cfg, dev, seed=CAUSAL_SEED)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    look = hift.f0_look_right(card_p) + hift.conv_pre_look_right(card_p)
    trim = int(np.prod(cfg.upsample_rates)) * cfg.istft_hop_len
    rec = dict(t_mel=t_mel, look_right=look)
    with torch.inference_mode():
        for name, params in (("served", card_p), ("voiced", voiced_hift(card_p, CAUSAL_VOICED_HZ))):
            cpu_p = tree_to_device(params, "cpu")
            f0 = hift.predict_f0_causal(params, cfg, mel)
            part_rec = dict(voiced_share=float((f0 > cfg.nsf_voiced_threshold).float().mean()))
            rec[name] = part_rec
            if name == "voiced" and part_rec["voiced_share"] < 1.0:
                fail(f"5q: the voiced CausalHiFT voiced {part_rec['voiced_share']} of its frames")
            for fin in (True, False):
                card = hift.inference_causal(params, cfg, mel, rand_ini, noise, finalize=fin)
                cpu = hift.inference_causal(cpu_p, cfg, mel.cpu(), rand_ini.cpu(), noise.cpu(),
                                            finalize=fin)
                want = (t_mel * cfg.upsample_scale if fin
                        else (t_mel - look) * cfg.upsample_scale - trim)
                err = float((card.cpu() - cpu).abs().max())
                part_rec[f"finalize_{fin}"] = dict(samples=card.shape[1], max_abs_err=err,
                                                   peak=float(cpu.abs().max()))
                if card.shape != (1, want) or not torch.isfinite(card).all() or err > CAUSAL_TOL:
                    fail(f"5q: {name} inference_causal finalize={fin}: shape "
                         f"{tuple(card.shape)} (want {want}), card vs CPU {err:.3g} "
                         f"(tol {CAUSAL_TOL})")
            full = hift.inference_causal(params, cfg, mel, rand_ini, noise)
            up, prefix_err, covered = cfg.upsample_scale, 0.0, 0
            for i in range(0, t_mel, CAUSAL_CHUNK):
                end = i + CAUSAL_CHUNK + look
                part = hift.inference_causal(params, cfg, mel[:, :, :min(end, t_mel)], rand_ini,
                                             noise, finalize=end >= t_mel)
                seg = part[:, i * up:]
                prefix_err = max(prefix_err, float((seg - full[:, i * up:i * up + seg.shape[1]])
                                                   .abs().max()))
                covered = i * up + seg.shape[1]
            part_rec.update(prefix_max_abs_err=prefix_err,
                            prefix_calls=-(-t_mel // CAUSAL_CHUNK))
            if covered != full.shape[1] or prefix_err >= CAUSAL_PREFIX_TOL:
                fail(f"5q: {name} growing prefix {prefix_err:.3g} (tol {CAUSAL_PREFIX_TOL}), "
                     f"{covered} of {full.shape[1]} samples")

        def ms(fn):
            for _ in range(2):
                fn()
            times = []
            for _ in range(CAUSAL_TIMED):
                sync()
                t0 = time.perf_counter()
                fn()
                sync()
                times.append((time.perf_counter() - t0) * 1000)
            return statistics.median(times)

        vocoder = TorchNoise(torch.Generator(device=dev).manual_seed(CAUSAL_SEED))
        rec["causal_ms"] = ms(lambda: hift.inference_causal(card_p, cfg, mel, rand_ini, noise))
        rec["inference_ms"] = ms(lambda: hift.inference(card_p, cfg, mel, vocoder))
    print("5q causal_hift", json.dumps(rec), flush=True)
    return rec


def drive_launcher(card, stop: threading.Event) -> dict:
    """Phase 5q.1 and 5q.2: the launcher with --with-ui as a subprocess, its
    page and routes, and loadgen's CLI against it (see the module
    docstring). It launches no kernel in this process, so it runs beside
    phase 5o (`Background`); `stop` ends it early. Returns its record."""
    import shutil
    import signal
    import tempfile

    def stopped():
        if stop.is_set():
            fail("5q: the launcher's checks were stopped: another phase failed")

    rec = {"card": card}
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="hydravox_5q_"))
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    log_path = ROOT / "chiprun_out" / "5q_launcher.log"
    log_path.parent.mkdir(exist_ok=True)
    t0 = time.time()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "flowmirror_hydravox_tpu_torch", "--with-ui", "--max-tokens",
             str(SERVE_MAX_TOKENS), "--api-host", "127.0.0.1", "--api-port", str(port),
             *SERVE_FLAGS],
            cwd=ROOT, env=env, stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
        try:
            while not launcher_up(base):
                stopped()
                if proc.poll() is not None:
                    fail(f"5q: the launcher exited with {proc.returncode}: "
                         f"{log_path.read_text()[-2000:]}")
                if time.time() - t0 > LAUNCHER_READY_S:
                    fail(f"5q: the launcher was not up within {LAUNCHER_READY_S} s")
                time.sleep(1.0)
            rec["launcher_ready_s"] = time.time() - t0
            rec["ui"] = check_ui(base, tmp)
            stopped()
            rec["loadgen"] = loadgen_runs(base, env, stopped)
        finally:
            for sig in (signal.SIGINT, signal.SIGKILL):  # SIGINT runs serve()'s shutdown
                try:
                    os.killpg(proc.pid, sig)
                except ProcessLookupError:
                    break
                try:
                    proc.wait(timeout=30)
                    break
                except subprocess.TimeoutExpired:
                    continue
            shutil.rmtree(tmp, ignore_errors=True)
    rec["wall_s"] = time.time() - t0
    return rec


class BenchProcess:
    """tools/bench_serving.py as a subprocess (BENCH_ARGS + SERVE_FLAGS),
    its JSON lines to chiprun_out/5q_bench.jsonl and its log beside them.
    It runs beside phases 5o and 5p, which launch no kernel of this
    process's counters into its count: the bench reports its own launches
    (its last line)."""

    def __init__(self):
        out = ROOT / "chiprun_out"
        out.mkdir(exist_ok=True)
        self.lines_path, self.log_path = out / "5q_bench.jsonl", out / "5q_bench.log"
        env = dict(os.environ,
                   PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.t0 = time.time()
        with open(self.lines_path, "w") as lines, open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "flowmirror_hydravox_tpu_torch.tools.bench_serving",
                 *BENCH_ARGS, *SERVE_FLAGS],
                cwd=ROOT, env=env, stdout=lines, stderr=log, start_new_session=True)

    def result(self) -> tuple:
        """(the JSON lines, wall seconds) once the bench has exited with 0."""
        try:
            rc = self.proc.wait(timeout=max(1.0, BENCH_LIMIT_S - (time.time() - self.t0)))
        except subprocess.TimeoutExpired:
            fail(f"5q: bench_serving still running after {BENCH_LIMIT_S} s")
        wall = time.time() - self.t0
        if rc != 0:
            fail(f"5q: bench_serving exited with {rc}: {self.log_path.read_text()[-3000:]}")
        return [json.loads(ln) for ln in self.lines_path.read_text().splitlines() if ln], wall

    def kill(self):
        import signal

        if self.proc.poll() is None:
            os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()


def drive_serving_tools(engine, frontend, da, mg, card, launcher: Background = None,
                        bench: BenchProcess = None):
    """Phase 5q: the launcher's record from `launcher` (drive_launcher,
    started beside 5o; run here when None), tools/bench_serving.py's lines
    and launches from `bench` (started with 5o; started here when None),
    then CausalHiFT (see the module docstring). Returns (record, the
    bench's launches)."""
    rec = {"card": card, "launcher": launcher.result() if launcher is not None
           else drive_launcher(card, threading.Event())}
    bench = bench or BenchProcess()
    try:
        lines, wall = bench.result()
    finally:
        bench.kill()
    for ln in lines:
        print("5q bench_serving", json.dumps(ln), flush=True)
    counted = [ln for ln in lines if ln.get("section") == "kernel_launches"]
    if len(counted) != 1:
        fail(f"5q: bench_serving reported its kernels' launches {len(counted)} times")
    launched = (counted[0]["decode_attention"], counted[0]["mlp_gemv"])
    rec["bench_serving"] = check_bench(lines)
    rec["bench_serving"]["wall_s"] = wall
    rec["bench_launches"] = list(launched)
    print("5q bench_serving launches (attention, mlp):", launched, flush=True)
    if min(launched) <= 0:
        fail(f"5q: bench_serving launched the kernels {launched} times")

    da.launch_count = mg.launch_count = 0
    rec["causal_hift"] = check_causal_hift(engine)
    if (da.launch_count, mg.launch_count) != (0, 0):
        fail(f"5q: CausalHiFT launched the kernels {(da.launch_count, mg.launch_count)} times")
    return rec, launched


def main():
    t_start = time.time()
    if not (ROOT / "flowmirror_hydravox_tpu_torch" / "csrc").is_dir():
        fail("the port package is not beside this script; run it from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA GPU")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # cuDNN may otherwise pick convolution algorithms that accumulate in a
    # run-dependent order, and phase 5c needs a seeded stream bit for bit
    torch.backends.cudnn.deterministic = True
    print("precision: TF32 off for matmuls and cuDNN convs (f32 runs in full f32); "
          "deterministic cuDNN algorithms", flush=True)

    card = census()
    print(f"census: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    from flowmirror_hydravox_tpu_torch import __main__ as launcher
    from flowmirror_hydravox_tpu_torch.ops import decode_attention as da
    from flowmirror_hydravox_tpu_torch.ops import mlp_gemv as mg
    from flowmirror_hydravox_tpu_torch.ops import nvcc_build
    from flowmirror_hydravox_tpu_torch.tools import eval_int8

    t0 = time.time()
    build_errors = []

    def build(op):
        try:
            op.build_library(force=True)
        except RuntimeError as e:
            build_errors.append(str(e))

    build_threads = [threading.Thread(target=build, args=(op,)) for op in (da, mg)]
    for th in build_threads:
        th.start()
    for th in build_threads:
        th.join()
    if build_errors:
        fail("build: " + "\n".join(build_errors))
    print(f"build: decode_attention.cu and mlp_gemv.cu in parallel in {time.time() - t0:.1f} s "
          f"(nvcc, sm_90a)", flush=True)
    for op in (da, mg):
        regs = [ln.strip() for ln in nvcc_build.build_log(op.KERNEL_SOURCE).read_text().splitlines()
                if "registers" in ln]
        print(f"ptxas {op.KERNEL_SOURCE.name}:", " | ".join(regs), flush=True)

    flush = torch.empty(64 * 2 ** 20, dtype=torch.int32, device="cuda")  # 256 MB > L2
    # the least time of one launch through the same timing loop: a
    # one-element zero_(), beside each kernel's bound
    one = torch.empty(1, device="cuda")
    launch_floor_ms = time_ms(lambda: one.zero_(), flush)
    print(f"launch floor: one-element zero_() {launch_floor_ms:.6f} ms", flush=True)
    # the zero-shot prefills of a 3 s and a 10 s prompt, as phase 5d sends them
    prefill_cases = zero_shot_prefill_cases()
    print("zero-shot prefill shapes (B, T, S_max, cache_len, Hq):", json.dumps(prefill_cases),
          flush=True)
    # and in phase 5f's flash batches: prefills and first decode steps
    batch_cases = batched_zero_shot_cases()
    print("batched zero-shot shapes (B, T, S_max, cache_len, Hq):", json.dumps(batch_cases),
          flush=True)
    attention_cases = check_decode_attention(
        da, flush, ATTENTION_CASES + list(prefill_cases.values()) + list(batch_cases.values())
        + [c for c in SPEC_ATTENTION_CASES if c not in ATTENTION_CASES])
    mlp_cases = check_mlp_gemv(
        mg, flush, MLP_CASES + [c for c in SPEC_MLP_CASES if c not in MLP_CASES]
        + MLP_EDGE_CASES)

    t0 = time.time()
    engine, frontend = launcher.build(launcher.parse_args(
        ["--device", "cuda", "--max-tokens", str(MAX_TOKENS)]))
    torch.cuda.synchronize()
    print(f"engine: default HydraVoxConfig(), random weights, tokenizer "
          f"{type(frontend.tokenizer).__name__}, text vocab {engine.cfg.llm.backbone.vocab_size}, "
          f"built in {time.time() - t0:.1f} s", flush=True)
    backbone_rel = check_backbone(engine)

    phase_s = {"1-4": time.time() - t_start}

    def phase(name, drive, *args):
        t0 = time.time()
        out = drive(*args)
        phase_s[name] = time.time() - t0
        return out

    requests, launches = phase("5", drive_main_path, engine, frontend, da, mg)
    serving, more = phase("5b", drive_continuous, engine, frontend, da, mg)
    streaming, streamed = phase("5c", drive_streams, engine, frontend, da, mg)
    zero_shot, zs_launched = phase("5d", drive_zero_shot, engine, frontend, da, mg, prefill_cases)
    pt_weights, pt_launched = phase("5e", drive_pt_weights, engine, da, mg)
    zs_batched, zsb_launched = phase("5f", drive_zero_shot_batched, engine, frontend, da, mg,
                                     batch_cases)
    solo_rule, solo_launched = phase("5g", drive_solo_rule, engine, frontend, da, mg)
    solo_rule = {"estimate_holds": solo_rule,
                 "estimate_falls_back": pt_weights.pop("solo_fallback")}
    with ServedShapes(da, mg) as served:
        spec, spec_launched = phase("5h", drive_spec, engine, frontend, da, mg)
    t0 = time.time()
    spec["kernels"] = check_served_shapes(served, da, mg, flush, spec_launched)
    phase_s["5h kernels"] = time.time() - t0
    with ServedShapes(da, mg) as served:
        int8, int8_launched, int8_tree = phase("5i", drive_int8, engine, frontend, da, mg)
    t0 = time.time()
    int8["eval_int8"] = eval_int8.evaluate(engine.cfg.llm, engine.llm_params, int8_tree,
                                           device=engine.device, **INT8_EVAL)
    print("eval_int8", json.dumps(int8["eval_int8"]), flush=True)
    phase_s["5i eval"] = time.time() - t0
    del int8_tree
    t0 = time.time()
    int8["kernels"] = check_int8_shapes(served, mg, flush, int8_launched[2])
    phase_s["5i kernels"] = time.time() - t0
    training, train_launched = phase("5j", drive_training, engine, frontend, da, mg, card)
    dpo = phase("5k", drive_dpo, engine, frontend, da, mg, card)
    with ServedShapes(da, mg) as served:
        readout, readout_launched = phase("5l", drive_spec_readout, engine, frontend, da, mg,
                                          flush)
    t0 = time.time()
    readout["kernels"] = check_served_shapes(served, da, mg, flush, readout_launched, phase="5l")
    phase_s["5l kernels"] = time.time() - t0
    gan, gan_launched = phase("5m", drive_gan, engine, frontend, da, mg, card)
    routes, routes_launched = phase("5n", drive_training_routes, engine, frontend, da, mg, card)
    # 5q.1-5q.2 (a launcher subprocess and HTTP clients) and 5q.3 (the bench
    # as a subprocess) launch no kernel of this process: they run beside 5o
    # and 5p, the whole run's time limit
    launcher, bench = Background(drive_launcher, card), BenchProcess()
    try:
        preprocess, pre_launched = phase("5o", drive_preprocess, engine, frontend, da, mg, card)
        extractors, ext_launched = phase("5p", drive_ext_training, engine, frontend, da, mg,
                                         card)
        serving_tools, tools_launched = phase("5q", drive_serving_tools, engine, frontend, da,
                                              mg, card, launcher, bench)
    finally:
        launcher.stop_and_join()
        bench.kill()
    phase_s["5q launcher (beside 5o)"] = launcher.wall_s
    phase_s["5q bench (beside 5o, 5p)"] = serving_tools["bench_serving"]["wall_s"]
    phase_s["all"] = time.time() - t_start
    print("phase seconds", json.dumps({k: round(v, 1) for k, v in phase_s.items()}), flush=True)
    attention_launches, mlp_launches = (sum(x) for x in zip(
        launches, more, streamed, zs_launched, pt_launched, zsb_launched, solo_launched,
        spec_launched, int8_launched[:2], train_launched, readout_launched, gan_launched,
        routes_launched, pre_launched, ext_launched, tools_launched))
    del flush

    # the kernels line: each kernel at its serving shape (bf16; decode
    # attention at B 1, T 2 against the 512-row cache the requests use; the
    # MLP at the backbone's M 2 of heads 2), max_abs_err over every case
    # checked in phases 3 and 3b
    att = next(c for c in attention_cases
               if c["dtype"] == "bfloat16" and c["B"] == 1 and c["T"] == 2 and c["cache_len"] == [255])
    mlp = next(c for c in mlp_cases
               if c["dtype"] == "bfloat16" and c["M"] == 2 and c["I"] == 4864)
    # the int8 form at its serving shape, as 5i served it (solo at heads 2)
    mlp_int8 = next((c for c in int8["kernels"]
                     if c["dtype"] == "bfloat16" and c["M"] == 2 and c["I"] == 4864), None)
    if mlp_int8 is None:
        fail("5i served no bf16 M 2 x 4864 launch of the int8 form")
    kernels = {"kernels": [{
        "name": "decode_attention",
        "route": "cuda",
        "source": "flowmirror_hydravox_tpu_torch/csrc/decode_attention.cu",
        "replaces": "flowmirror_hydravox_tpu/ops/pallas_attention.py:97",
        "launches": attention_launches,
        "max_abs_err": max(c["max_abs_err"] for c in attention_cases),
        "ms": att["kernel_ms"],
        "plain_ms": att["ref_ms"],
        "bound_ms": att["bound_ms"],
        "bound_by": att["bound_by"],
        "launch_floor_ms": launch_floor_ms,
        "library_ms": att["library_ms"],
    }, {
        "name": "mlp_gemv",
        "route": "cuda",
        "source": "flowmirror_hydravox_tpu_torch/csrc/mlp_gemv.cu",
        "replaces": "flowmirror_hydravox_tpu/ops/pallas_mlp.py:52",
        "launches": mlp_launches,
        "max_abs_err": max(c["max_abs_err"] for c in mlp_cases),
        "ms": mlp["kernel_ms"],
        "plain_ms": mlp["ref_ms"],
        "bound_ms": mlp["bound_ms"],
        "bound_by": mlp["bound_by"],
        "launch_floor_ms": launch_floor_ms,
        "library_ms": mlp["library_ms"],  # the torch.matmul form, a yardstick
    }, {
        "name": "mlp_gemv_int8",
        "route": "cuda",
        "source": "flowmirror_hydravox_tpu_torch/csrc/mlp_gemv.cu",
        "replaces": "flowmirror_hydravox_tpu/ops/pallas_mlp.py:52",
        "launches": int8_launched[2],
        "max_abs_err": max(c["max_abs_err"] for c in int8["kernels"]),
        "ms": mlp_int8["kernel_ms"],
        "plain_ms": mlp_int8["ref_ms"],
        "bound_ms": mlp_int8["bound_ms"],
        "bound_by": mlp_int8["bound_by"],
        "launch_floor_ms": launch_floor_ms,
        # the torch.matmul form on the dequantized weights, a yardstick
        "library_ms": mlp_int8["library_ms"],
    }]}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "launch_floor_ms": launch_floor_ms, "attention_cases": attention_cases,
         "mlp_cases": mlp_cases, "backbone_rel_err": backbone_rel, "requests": requests,
         "serving": serving, "streaming": streaming, "zero_shot": zero_shot,
         "pt_weights": pt_weights, "zero_shot_batched": zs_batched, "solo_route": solo_rule,
         "spec_decode": spec, "int8": int8, "training": training, "dpo": dpo,
         "spec_readout": readout, "gan": gan, "training_routes": routes,
         "preprocess": preprocess, "extractor_training": extractors,
         "serving_tools": serving_tools, "phase_s": phase_s,
         **kernels},
        indent=1))
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if len(sys.argv) > 1:
        ab_main(sys.argv[1:])
    else:
        main()
