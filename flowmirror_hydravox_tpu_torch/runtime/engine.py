"""Inference engine: text tokens -> speech tokens -> mel -> 24 kHz waveform.

Port of flowmirror_hydravox_tpu/runtime/engine.py, run eagerly in two
stages, for one utterance (`synthesize`, SFT or zero-shot with the LM's own
prompt prefix), for the flash batch of several (`synthesize_batch`, per-row
prompts, LM prefixes and tts-portion lengths), and for voice conversion
(`voice_convert`: stage 2 alone on a source's speech tokens):

  - stage 1: prompt assembly, KV-cache prefill and multi-head decode
    (models/llm.py), the attention of every layer going through the Hopper
    decode-attention kernel on the card;
  - stage 2: flow (10 Euler steps over the DiT) and HiFT on a token buffer
    padded to a bucket of SYNTH_BUCKETS, with the prompt-mel region cut off,
    the mel edge-replicated past the valid end and the wav quantised to int16.

The bucket ladders are the JAX package's: HiFT's convs are non-causal, so the
padded tail changes the last samples, and the same buckets give the same wav
(the continuous batcher's synthesis, `synthesize_tokens`, takes TOKEN_BUCKETS
as the JAX batcher does). `synthesize` and `synthesize_batch` keep the
output rule of the JAX engine's default `fused=True` (engine.py:1121-1170,
:760-798): at speed 1, stage 2 runs at a bucket estimated from the text
length before decoding (`_estimate_token_bucket`) whenever the realised
tokens fit in it, else at the realised bucket. Only the bucket is JAX's; no
graph is fused here, and stage 2 runs once either way, since the token count
is known by then. `fused=False` gives the two-stage rule (always the
realised bucket). `spec_decode=True` decodes every request at two heads or
more by self-speculative MTP verification (`llm.generate_speculative` and
`generate_batched_speculative`, engine.py:227-245, :388-405), the exact
heads=1 output distribution. `quantize="int8"` serves the LLM as
weight-only int8 (ops/quant.py; engine.py:178-197): every route then runs
on the int8 tree, the decode MLP through the int8 form of the MLP kernel;
the flow and HiFT are never quantized.

Metrics follow the reference definitions (infer_speech_model.py:563-604):
tps = tokens / llm_time, rtf = total_time / audio seconds. The two stages are
`engine.llm` and `engine.synth` spans for torch.profiler
(tools/profile_decode.py reads them); without a profiler they cost a few
microseconds per request.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..config import HydraVoxConfig, SamplingConfig
from ..device import resolve_device
from ..models import flow as flow_model
from ..models import hift as hift_model
from ..models import llm as llm_model
from ..noise import SeededVocoder, StreamNoise, TorchNoise
from ..ops.quant import check_mode, quantize_llm_params
from ..ops.sampling import SamplingParams
from ..params import cast_like, from_numpy_tree

logger = logging.getLogger("hydravox.engine")


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


PROMPT_BUCKETS = (32, 64, 128, 256, 512, 1024)
MEL_BUCKETS = (128, 256, 512, 1024, 2048)
# the coarse token ladder, which the JAX continuous batcher's synthesis takes
# (continuous.py:1344, `Engine._bucket_token`)
TOKEN_BUCKETS = (32, 64, 128, 256, 512, 1024)
# finer ladder for the flow + HiFT stage of the two-stage paths, whose cost is
# linear in the padded bucket
SYNTH_BUCKETS = (32, 64, 96, 128, 160, 192, 256, 384, 512, 768, 1024)
# speech-token length bounds per text token (infer_speech_model.py)
MIN_TOKEN_TEXT_RATIO = 2.0
MAX_TOKEN_TEXT_RATIO = 20.0
# speech tokens per tts text token that the estimated stage-2 bucket assumes
# (the JAX Engine's `fused_est_ratio`, engine.py:93)
FUSED_EST_RATIO = 6.0


@dataclasses.dataclass
class SynthesisResult:
    audio: np.ndarray  # (T,) float32 at cfg.sample_rate
    speech_tokens: np.ndarray
    llm_time: float
    synth_time: float  # flow + hift
    total_time: float
    tps: float
    rtf: float
    steps: int
    token_bucket: int = 0  # stage 2's token bucket
    estimated: bool = False  # whether it was the estimated bucket (fused rule)
    # speculative decoding only: drafts accepted / drafts proposed (else -1)
    spec_acceptance: float = -1.0


class Engine:
    """Holds the three models' parameter trees on one device.

    `fused` (default True, as in JAX) selects the output rule of
    `synthesize` and `synthesize_batch`: the estimated stage-2 bucket when
    the tokens fit it (see the module docstring); False always takes the
    realised bucket.

    `spec_decode`: decodes at two heads or more draft with MTP heads
    1..K-1 and verify against head 0 (engine.py:116-124): one utterance
    (`llm.generate_speculative`), the flash batch
    (`generate_batched_speculative`), streams (`generate_spec_until`) and,
    through the server, the continuous slots.

    `quantize`: None, "none" or "bf16" keeps the LLM tree as given; "int8"
    quantizes it (`ops.quant.quantize_llm_params`), and a hot reload
    (`load_weights`) quantizes the new tree again; anything else raises
    ValueError (engine.py:178-186)."""

    def __init__(self, cfg: HydraVoxConfig, llm_params, flow_params, hift_params,
                 max_tokens: int = 1024, device="cuda", fused: bool = True,
                 spec_decode: bool = False, quantize: Optional[str] = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.quantize = quantize
        # the dtype a reloaded LLM tree is cast to before the policy applies
        # (engine.py:133-137), read before quantization rewrites the tree
        self._llm_dtype = llm_params["backbone"]["embed_tokens"].dtype
        self.llm_params = self._prepare_llm_params(llm_params)
        self.flow_params = flow_params
        self.hift_params = hift_params
        self.max_tokens = max_tokens
        self.fused = fused
        self.spec_decode = bool(spec_decode)
        self._generator = torch.Generator(device=self.device).manual_seed(int(time.time()))
        self._rng_lock = threading.Lock()
        self._streaming = None

    def _next_seed(self) -> int:
        """A seed drawn from the engine's generator (requests may come from
        several threads)."""
        with self._rng_lock:
            return int(torch.randint(0, 2 ** 62, (1,), generator=self._generator,
                                     device=self.device).item())

    def next_noise(self) -> TorchNoise:
        """A noise source for one synthesis, forked off the engine's generator."""
        return self.noise_for(self._next_seed())

    def noise_for(self, seed: Optional[int]) -> TorchNoise:
        """The noise source of `seed`, or `next_noise()` for None."""
        if seed is None:
            return self.next_noise()
        return TorchNoise(torch.Generator(device=self.device).manual_seed(int(seed)))

    def stream_noise(self, seed: Optional[int] = None) -> StreamNoise:
        """A stream's two sources (decode, vocoder), both derived from `seed`
        (default: drawn from the engine's generator), on the solo and the
        slot routes alike."""
        seed = self._next_seed() if seed is None else int(seed)
        split = torch.Generator().manual_seed(seed)
        decode_seed, vocoder_seed = torch.randint(0, 2 ** 62, (2,), generator=split).tolist()
        return StreamNoise(self.noise_for(decode_seed), SeededVocoder(vocoder_seed, self.device))

    def streaming(self):
        """The engine's one StreamingSynthesizer (JAX engine.py:976-983),
        shared by the solo stream lane and the continuous slots."""
        with self._rng_lock:
            if self._streaming is None:
                from .streaming import StreamingSynthesizer

                self._streaming = StreamingSynthesizer(self)
            return self._streaming

    def _prepare_llm_params(self, params: dict) -> dict:
        """The LLM tree under the engine's `quantize` policy."""
        check_mode(self.quantize)
        return quantize_llm_params(params) if self.quantize == "int8" else params

    def load_weights(self, trees: dict, hold=contextlib.nullcontext()):
        """Hot reload (POST /api/v1/load_pt): `trees` ({llm, flow, hift}:
        numpy trees in the JAX layout) go to the engine's device and are
        swapped in together inside `hold` (the continuous batcher holds its
        slots between two ticks there). The LLM is cast to the dtype the
        engine was built with and then takes the `quantize` policy again
        (JAX `set_llm_params`, engine.py:188-197); the flow and HiFT take
        each leaf at the dtype of the live leaf it replaces. A call already
        running keeps the trees it started with."""
        new = {}
        for name, tree in trees.items():
            if name == "llm":
                new[name] = self._prepare_llm_params(
                    from_numpy_tree(tree, self.device, self._llm_dtype))
            else:
                new[name] = cast_like(tree, getattr(self, f"{name}_params"), self.device)
        with hold:
            for name, tree in new.items():
                setattr(self, f"{name}_params", tree)

    def speculates(self, head_num: int) -> bool:
        """Whether a decode at `head_num` heads verifies drafts: with
        spec_decode, from two heads on; one head has nothing to draft with
        and takes the plain decode (engine.py:234)."""
        return self.spec_decode and int(head_num) >= 2

    def _tensor(self, arr, dtype):
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=self.device)

    @staticmethod
    def _estimate_token_bucket(tts_text_len: int, min_len: int, max_len: int,
                               flow_prompt_len: int) -> int:
        """Stage 2's token bucket estimated before decoding (engine.py:203-208)."""
        est = min(max_len, max(min_len, int(tts_text_len * FUSED_EST_RATIO)))
        return _bucket(max(flow_prompt_len + est, 1), SYNTH_BUCKETS)

    @staticmethod
    def _stage2_bucket(n_all: int, est_bkt: int):
        """(token bucket, whether the estimate held) for `n_all` prompt and
        generated tokens: `est_bkt` when they fit it (JAX keeps the fused
        program's wav, engine.py:1140-1142), else the realised bucket."""
        if n_all <= est_bkt:
            return est_bkt, True
        return _bucket(max(n_all, 1), SYNTH_BUCKETS), False

    # -- stages --------------------------------------------------------------

    def _generate(self, text_pad, lt, sp_pad, lp, min_len, max_len, sampling, head_num, noise):
        """Stage 1: text tokens + prompt speech tokens -> (GenerateResult,
        spec_acceptance: accepted / drafted drafts, -1 when not speculating)."""
        cfg = self.cfg.llm
        cache_cap = 2 + len(text_pad) + len(sp_pad) + self.max_tokens + head_num
        emb, plen = llm_model.build_inference_prompt(
            self.llm_params, cfg, self._tensor(text_pad, torch.int32), lt,
            self._tensor(sp_pad, torch.int32), lp,
        )
        if self.speculates(head_num):
            spec = llm_model.generate_speculative(
                self.llm_params, cfg, emb, plen, min_len, max_len, sampling, noise,
                num_heads=head_num, max_tokens=self.max_tokens, cache_len_cap=cache_cap)
            return spec.result, spec.accepted / max(spec.drafted, 1)
        return llm_model.generate(
            self.llm_params, cfg, emb, plen, min_len, max_len, sampling, noise,
            inference_head_num=head_num, max_tokens=self.max_tokens, cache_len_cap=cache_cap,
        ), -1.0

    def _synth_body(self, token_bucket: int, pm_bucket: int, sp_bucket: int, tokens, num,
                    sp_tokens, sp_len, prompt_mel, pm_len, embedding, noise):
        """Stage 2: flow + HiFT on the bucket-padded token buffers of B rows
        (`_synth_body` :278 for one row, `_batch_synth_body` :448 for B).
        tokens (B, >= 1) generated, num (B,) counts; sp_tokens (B, sp_bucket),
        sp_len (B,); prompt_mel (B, pm_bucket, 80), pm_len (B,); embedding
        (B or 1, 192); counts are host integer sequences. Returns
        (wav_i16 (B, token_bucket*ratio*upsample), mel (B, 80, t_mel))."""
        fcfg, hcfg = self.cfg.flow, self.cfg.hift
        ratio = fcfg.token_mel_ratio
        t_mel = token_bucket * ratio
        dev = self.device
        b = tokens.shape[0]
        num = torch.as_tensor(np.asarray(num, np.int64), device=dev)[:, None]
        sp_len = torch.as_tensor(np.asarray(sp_len, np.int64), device=dev)[:, None]
        pm_len = torch.as_tensor(np.asarray(pm_len, np.int64), device=dev)

        pos = torch.arange(token_bucket, device=dev)[None, :]
        gen_idx = torch.clamp(pos - sp_len, 0, tokens.shape[1] - 1)
        seq = torch.gather(tokens, 1, gen_idx)
        if sp_bucket > 0:
            sp_idx = torch.clamp(pos, 0, sp_bucket - 1).expand(b, token_bucket)
            seq = torch.where(pos < sp_len, torch.gather(sp_tokens, 1, sp_idx), seq)
        valid = pos < sp_len + num

        emb = embedding.expand(b, embedding.shape[-1])
        mel = flow_model.inference(self.flow_params, fcfg, seq, valid, prompt_mel, pm_len,
                                   emb)  # (B, 80, t_mel) f32
        # drop each row's prompt-mel region, then edge-replicate past its
        # valid end so the f0 convs near the boundary see plausible context
        mel_pad = torch.nn.functional.pad(mel, (0, pm_bucket))
        frame = torch.arange(t_mel, device=dev)[None, :]
        src = pm_len[:, None] + torch.minimum(frame, torch.clamp_min(num * ratio - 1, 0))
        mel_gen = torch.gather(mel_pad, 2, src[:, None, :].expand(b, mel.shape[1], t_mel))

        wav = hift_model.inference(self.hift_params, hcfg, mel_gen, noise)
        wav_i16 = (torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        return wav_i16, mel_gen

    @staticmethod
    def _text_row(text_tokens, tts_text_len: int):
        """(text_pad (tbkt,) int32 over PROMPT_BUCKETS, lt, tts_text_len); a
        text past the largest bucket is cut off, with a warning."""
        text_tokens = np.asarray(text_tokens, np.int32)
        lt = len(text_tokens)
        tbkt = _bucket(lt, PROMPT_BUCKETS)
        if lt > tbkt:
            logger.warning("text of %d tokens exceeds the largest prompt bucket %d; truncating",
                           lt, tbkt)
            text_tokens, lt = text_tokens[:tbkt], tbkt
            tts_text_len = min(int(tts_text_len), tbkt)
        text_pad = np.zeros((tbkt,), np.int32)
        text_pad[:lt] = text_tokens
        return text_pad, lt, tts_text_len

    def _prefill(self, text_pad, lt: int, sp_pad, lp: int, head_num: int, min_len: int,
                 max_len: int, sampling: SamplingParams, noise) -> dict:
        """Prompt assembly and KV-cache prefill: the decode state that
        `llm.generate_until` resumes (the streaming LM), or, when the engine
        speculates at `head_num`, `llm.init_spec_state`'s, whose first token
        draws from `noise`, for `generate_spec_until`."""
        cfg = self.cfg.llm
        emb, plen = llm_model.build_inference_prompt(
            self.llm_params, cfg, self._tensor(text_pad, torch.int32), lt,
            self._tensor(sp_pad, torch.int32), lp,
        )
        cap = 2 + len(text_pad) + len(sp_pad) + self.max_tokens + head_num
        if self.speculates(head_num):
            return llm_model.init_spec_state(
                self.llm_params, cfg, emb, plen, min_len, max_len, sampling, noise,
                num_heads=head_num, max_tokens=self.max_tokens, cache_len_cap=cap)
        return llm_model.init_generate_state(
            self.llm_params, cfg, emb, plen, inference_head_num=head_num,
            max_tokens=self.max_tokens, cache_len_cap=cap,
        )

    @staticmethod
    def _speech_row(prompt_speech_tokens):
        """(sp_pad (sbkt,) int32 over PROMPT_BUCKETS, lp); tokens past the
        largest bucket are cut off."""
        sp = (np.zeros((0,), np.int32) if prompt_speech_tokens is None
              else np.asarray(prompt_speech_tokens, np.int32))
        sbkt = _bucket(len(sp), PROMPT_BUCKETS) if len(sp) else 0
        sp = sp[:sbkt]
        sp_pad = np.zeros((sbkt,), np.int32)
        sp_pad[:len(sp)] = sp
        return sp_pad, len(sp)

    def _row_prompts(self, prompt_speech_tokens, prompt_mel):
        """One row's prompt buffers at their buckets: (sp_pad (sbkt,) int32
        over PROMPT_BUCKETS, lp, pm (1, pm_bucket, 80) f32 over MEL_BUCKETS,
        pm_len). Prompt tokens past the largest bucket are cut off."""
        sp_pad, lp = self._speech_row(prompt_speech_tokens)
        n_mel = self.cfg.flow.output_size
        if prompt_mel is not None and len(prompt_mel) > 0:
            pm_len = len(prompt_mel)
            pm = np.zeros((1, _bucket(pm_len, MEL_BUCKETS), n_mel), np.float32)
            pm[0, :pm_len] = prompt_mel
        else:
            pm, pm_len = np.zeros((1, 0, n_mel), np.float32), 0
        return sp_pad, lp, pm, pm_len

    def _resample_and_vocode(self, mel_gen, n_frames: int, speed: float, noise) -> np.ndarray:
        """speed != 1: resample the mel linearly on the host, then re-vocode
        (infer_speech_model.py:586-587)."""
        up = self.cfg.hift.upsample_scale
        mel = mel_gen.cpu().numpy()[:, :, :n_frames]
        new_t = max(1, int(mel.shape[2] / speed))
        src = np.linspace(0, mel.shape[2] - 1, new_t)
        lo = np.floor(src).astype(int)
        hi = np.minimum(lo + 1, mel.shape[2] - 1)
        w = (src - lo).astype(np.float32)
        mel = (mel[:, :, lo] * (1 - w) + mel[:, :, hi] * w).astype(np.float32)
        mbkt = _bucket(mel.shape[2], MEL_BUCKETS)
        mel_pad = np.concatenate([mel, np.repeat(mel[:, :, -1:], mbkt - mel.shape[2], axis=2)],
                                 axis=2)
        hift_dtype = self.hift_params["conv_pre"]["w"].dtype
        wav = hift_model.inference(self.hift_params, self.cfg.hift,
                                   self._tensor(mel_pad, hift_dtype), noise)
        return wav[0, : mel.shape[2] * up].float().cpu().numpy()

    # -- entry point ---------------------------------------------------------

    @torch.inference_mode()
    def synthesize(
        self,
        text_tokens: np.ndarray,  # (Lt,) int32: prompt_text + tts_text tokens
        tts_text_len: int,  # length of the tts portion (min/max len base)
        sampling: Optional[SamplingConfig] = None,
        inference_head_num: Optional[int] = None,
        prompt_speech_tokens: Optional[np.ndarray] = None,  # (Lp,) flow prompt
        prompt_mel: Optional[np.ndarray] = None,  # (Lm, 80)
        spk_embedding: Optional[np.ndarray] = None,  # (192,)
        speed: float = 1.0,
        noise=None,
        llm_prompt_speech_tokens: Optional[np.ndarray] = None,  # LM prefix override
        max_token_text_ratio: float = MAX_TOKEN_TEXT_RATIO,
        min_token_text_ratio: float = MIN_TOKEN_TEXT_RATIO,
    ) -> SynthesisResult:
        """Single-utterance synthesis (reference inference_tts /
        inference_zero_shot, infer_speech_model.py:523-689). `noise` (default:
        drawn from the engine's generator) feeds both the LM's sampling and
        HiFT's source, as the JAX engine feeds one key to both.

        `llm_prompt_speech_tokens` (engine.py:1047-1067) is the LM's prompt
        speech prefix: None means the flow's `prompt_speech_tokens`, an empty
        array none at all (cross-lingual and instruct2,
        cli/frontend.py:186-209). The flow always takes its own prompt."""
        t_start = time.time()
        cfg = self.cfg
        sampling = sampling or cfg.tts_sampling
        head_num = inference_head_num or cfg.llm.inference_head_num
        noise = noise if noise is not None else self.next_noise()
        if spk_embedding is None:
            spk_embedding = np.zeros((192,), np.float32)

        # ---- shared padding/bucketing ----
        text_pad, lt, tts_text_len = self._text_row(text_tokens, tts_text_len)
        sp_pad, lp, pm, pm_len = self._row_prompts(prompt_speech_tokens, prompt_mel)
        sbkt, pm_bucket = len(sp_pad), pm.shape[1]
        llm_sp_pad, llm_lp = ((sp_pad, lp) if llm_prompt_speech_tokens is None
                              else self._speech_row(llm_prompt_speech_tokens))

        min_len = int(tts_text_len * min_token_text_ratio)
        max_len = min(int(tts_text_len * max_token_text_ratio), self.max_tokens)
        sp = SamplingParams.make(sampling.top_p, sampling.top_k, sampling.win_size, sampling.tau_r)

        ratio = cfg.flow.token_mel_ratio
        up = cfg.hift.upsample_scale

        # ---- stage 1: LLM ----
        t0 = time.time()
        with torch.profiler.record_function("engine.llm"):
            res, spec_acceptance = self._generate(text_pad, lt, llm_sp_pad, llm_lp, min_len,
                                                  max_len, sp, head_num, noise)
        n_tok, steps = res.num_tokens, res.steps
        llm_time = time.time() - t0

        # ---- stage 2: flow + hift, at the estimated bucket when the tokens
        # fit it (the fused rule, speed 1), else at the realised one ----
        t0 = time.time()
        est_bkt = (self._estimate_token_bucket(tts_text_len, min_len, max_len, lp)
                   if self.fused and speed == 1.0 else 0)
        tok_bkt, estimated = self._stage2_bucket(lp + n_tok, est_bkt)
        flow_dtype = self.flow_params["input_embedding"].dtype
        with torch.profiler.record_function("engine.synth"):
            wav_dev, mel_dev = self._synth_body(
                tok_bkt, pm_bucket, sbkt, res.tokens[None], [n_tok],
                self._tensor(sp_pad[None], torch.int32), [lp], self._tensor(pm, flow_dtype),
                [pm_len], self._tensor(spk_embedding[None], torch.float32), noise,
            )
            if speed != 1.0:
                wav = self._resample_and_vocode(mel_dev, n_tok * ratio, speed, noise)
            else:
                wav = wav_dev[0, : n_tok * ratio * up].cpu().numpy().astype(np.float32) / 32767.0
        synth_time = time.time() - t0

        tokens = res.tokens[:n_tok].cpu().numpy()
        total = time.time() - t_start
        dur = len(wav) / cfg.sample_rate if len(wav) else 1e-9
        result = SynthesisResult(
            audio=wav.astype(np.float32),
            speech_tokens=tokens,
            llm_time=llm_time,
            synth_time=synth_time,
            total_time=total,
            tps=n_tok / llm_time if llm_time > 0 else 0.0,
            rtf=total / dur,
            steps=steps,
            token_bucket=tok_bkt,
            estimated=estimated,
            spec_acceptance=spec_acceptance,
        )
        logger.info("synth: %d tokens in %d steps, tps=%.1f rtf=%.4f (llm %.3fs flow+hift %.3fs "
                    "at the %s bucket %d)", n_tok, steps, result.tps, result.rtf, llm_time,
                    synth_time, "estimated" if estimated else "realised", tok_bkt)
        return result

    @torch.inference_mode()
    def voice_convert(self, source_speech_tokens, prompt_speech_tokens, prompt_mel,
                      spk_embedding, noise=None) -> np.ndarray:
        """Voice conversion (engine.py:994-1032; reference vc_job,
        cli/model.py:123-130): the source's speech tokens bypass the LM and
        the flow re-voices them with the prompt's timbre, at SYNTH_BUCKETS
        with the prompt mel over MEL_BUCKETS, in the (max_tokens,) token
        buffer the TTS paths use. `noise` (default: drawn from the engine's
        generator) feeds HiFT's source. Returns the float32 wav."""
        src = np.asarray(source_speech_tokens, np.int32)[: self.max_tokens]
        buf = np.zeros((self.max_tokens,), np.int32)
        buf[:len(src)] = src
        return self._synth_row(self._tensor(buf, torch.int32), len(src),
                               noise if noise is not None else self.next_noise(),
                               prompt_speech_tokens, prompt_mel, spk_embedding, SYNTH_BUCKETS)

    @torch.inference_mode()
    def synthesize_tokens(self, tokens, num: int, noise, prompt_speech_tokens=None,
                          prompt_mel=None, spk_embedding=None) -> np.ndarray:
        """Stage 2 alone for one row of generated tokens, as the JAX continuous
        batcher synthesises a finished slot (continuous.py:1339-1379): the
        tokens in a (max_tokens,) buffer, -1 past `num`, padded to a bucket of
        the coarse TOKEN_BUCKETS. tokens: a (>= max_tokens,) int32 tensor on
        the engine's device. Returns the float32 wav."""
        return self._synth_row(tokens, num, noise, prompt_speech_tokens, prompt_mel,
                               spk_embedding, TOKEN_BUCKETS)

    def _synth_row(self, tokens, num: int, noise, prompt_speech_tokens, prompt_mel,
                   spk_embedding, buckets) -> np.ndarray:
        """Flow + HiFT on one row's token buffer at a bucket of `buckets`."""
        sp_pad, lp, pm, pm_len = self._row_prompts(prompt_speech_tokens, prompt_mel)
        emb = (np.zeros((192,), np.float32) if spk_embedding is None
               else np.asarray(spk_embedding, np.float32).reshape(-1)[:192])
        tok_bkt = _bucket(max(lp + num, 1), buckets)
        flow_dtype = self.flow_params["input_embedding"].dtype
        with torch.profiler.record_function("engine.synth"):
            wav_dev, _ = self._synth_body(
                tok_bkt, pm.shape[1], len(sp_pad), tokens[None, :self.max_tokens], [num],
                self._tensor(sp_pad[None], torch.int32), [lp], self._tensor(pm, flow_dtype),
                [pm_len], self._tensor(emb[None], torch.float32), noise,
            )
            n_samples = num * self.cfg.flow.token_mel_ratio * self.cfg.hift.upsample_scale
            return wav_dev[0, :n_samples].cpu().numpy().astype(np.float32) / 32767.0

    @torch.inference_mode()
    def synthesize_batch(
        self,
        text_tokens_list,  # list of (Lt_i,) int32 arrays
        sampling: Optional[SamplingConfig] = None,
        inference_head_num: Optional[int] = None,
        prompt_speech_tokens=None,  # one shared (Lp,) array, or a per-row list
        prompt_mel=None,  # one shared (Lm, 80) array, or a per-row list
        spk_embedding=None,  # (192,) shared, or (B, 192) per row
        noise=None,
        tts_text_lens=None,  # per-row tts-portion lengths; None: whole texts
        llm_prompt_speech_tokens="same",  # LM-prefix override, see below
    ):
        """Flash-batch synthesis (engine.py:623-897, its two-stage form): B
        utterances (the segments of one text, or coalesced requests, SFT and
        zero-shot mixed) decode in one `llm.generate_batched` loop, then flow
        + HiFT run once over all rows, with `synthesize`'s bucket rule over
        the longest row (the estimate from the longest tts portion under
        `fused`, for fewer than 4 rows or tight length bounds). `noise`
        (default: drawn from the engine's generator) feeds both the LM and
        HiFT, as one JAX key does. Returns (list of B float32 wavs, stats
        dict with llm_time, synth_time, total_time, tokens, steps, rtf,
        token_bucket, estimated, spec_acceptance: the rows' accepted over
        drafted drafts, -1 when not speculating).

        Row i's token-length bounds come from `tts_text_lens[i]` (capped at
        its text's length), or from its whole text when None, as for SFT
        rows with no prompt text. `llm_prompt_speech_tokens` is the LM's
        prompt speech prefix, as in `synthesize`: "same" (each row's flow
        prompt), a per-row list (None: that row's flow prompt; empty: no
        prefix, cross-lingual and instruct2 rows), or one shared array. The
        flow always takes each row's own prompt.
        Not ported: the single dispatch itself (:770-798) and the warm-shape
        synth-group planner (:512-, which exists for XLA compile reuse)."""
        t_start = time.time()
        cfg = self.cfg
        sampling = sampling or cfg.tts_sampling
        head_num = inference_head_num or cfg.llm.inference_head_num
        noise = noise if noise is not None else self.next_noise()
        bsz = len(text_tokens_list)

        def _rows(x, dtype, empty_shape):
            if isinstance(x, (list, tuple)):
                if len(x) != bsz:
                    raise ValueError(f"{len(x)} per-row prompts for {bsz} rows")
                return [np.zeros(empty_shape, dtype) if r is None or len(r) == 0
                        else np.asarray(r, dtype) for r in x]
            shared = (np.zeros(empty_shape, dtype) if x is None or len(x) == 0
                      else np.asarray(x, dtype))
            return [shared] * bsz

        flow_sp_rows = _rows(prompt_speech_tokens, np.int32, (0,))
        if isinstance(llm_prompt_speech_tokens, str):  # "same"
            sp_rows = flow_sp_rows
        elif isinstance(llm_prompt_speech_tokens, (list, tuple)):
            if len(llm_prompt_speech_tokens) != bsz:
                raise ValueError(f"{len(llm_prompt_speech_tokens)} LM prefixes for {bsz} rows")
            sp_rows = [flow_sp_rows[i] if e is None else np.asarray(e, np.int32).reshape(-1)
                       for i, e in enumerate(llm_prompt_speech_tokens)]
        else:
            sp_rows = [np.asarray(llm_prompt_speech_tokens, np.int32).reshape(-1)] * bsz
        pm_rows = _rows(prompt_mel, np.float32, (0, cfg.flow.output_size))
        if spk_embedding is None:
            spk_embedding = np.zeros((192,), np.float32)
        spk_embedding = np.asarray(spk_embedding, np.float32)
        emb_rows = spk_embedding if spk_embedding.ndim == 2 else spk_embedding[None]

        # ---- shared padding/bucketing ----
        text_rows = [np.asarray(t, np.int32) for t in text_tokens_list]
        tbkt = _bucket(max(len(t) for t in text_rows), PROMPT_BUCKETS)
        if any(len(t) > tbkt for t in text_rows):
            logger.warning("text rows longer than the largest prompt bucket %d truncated", tbkt)
            text_rows = [t[:tbkt] for t in text_rows]
        lts = [len(t) for t in text_rows]
        tts_lens = (lts if tts_text_lens is None
                    else [min(int(n), lt) for n, lt in zip(tts_text_lens, lts)])

        def _pad(rows):
            """(B, bucket) int32 over PROMPT_BUCKETS (0 for no row), lengths."""
            longest = max(len(r) for r in rows)
            bkt = _bucket(longest, PROMPT_BUCKETS) if longest else 0
            lens = [min(len(r), bkt) for r in rows]
            pad = np.zeros((bsz, bkt), np.int32)
            for i, r in enumerate(rows):
                pad[i, :lens[i]] = r[:bkt]
            return pad, lens

        text_pad = np.zeros((bsz, tbkt), np.int32)
        for i in range(bsz):
            text_pad[i, :lts[i]] = text_rows[i]
        sp_pad, lps = _pad(sp_rows)  # the LM's prefixes
        fsp_pad, flps = _pad(flow_sp_rows)  # the flow's prompts
        sbkt = sp_pad.shape[1]
        min_lens = [int(n * MIN_TOKEN_TEXT_RATIO) for n in tts_lens]
        max_lens = [min(int(n * MAX_TOKEN_TEXT_RATIO), self.max_tokens) for n in tts_lens]
        sp = SamplingParams.make(sampling.top_p, sampling.top_k, sampling.win_size, sampling.tau_r)

        lm_max = max(len(r) for r in pm_rows)
        pm_bucket = _bucket(lm_max, MEL_BUCKETS) if lm_max else 0
        pm = np.zeros((bsz, pm_bucket, cfg.flow.output_size), np.float32)
        pm_lens = [min(len(r), pm_bucket) for r in pm_rows]
        for i, r in enumerate(pm_rows):
            pm[i, :pm_lens[i]] = r[:pm_bucket]

        ratio = cfg.flow.token_mel_ratio
        up = cfg.hift.upsample_scale

        # ---- stage 1: the batched decode ----
        t0 = time.time()
        with torch.profiler.record_function("engine.llm"):
            llm_cfg = cfg.llm
            text_dev = self._tensor(text_pad, torch.int32)
            sp_dev = self._tensor(sp_pad, torch.int32)
            prompts = [llm_model.build_inference_prompt(
                self.llm_params, llm_cfg, text_dev[i], lts[i], sp_dev[i], lps[i])
                for i in range(bsz)]
            args = (self.llm_params, llm_cfg, torch.stack([e for e, _ in prompts]),
                    [n for _, n in prompts], min_lens, max_lens, sp, noise)
            cap = 2 + tbkt + sbkt + self.max_tokens + head_num
            spec_acceptance = -1.0
            if self.speculates(head_num):
                spec = llm_model.generate_batched_speculative(
                    *args, num_heads=head_num, max_tokens=self.max_tokens, cache_len_cap=cap)
                res, spec_acceptance = spec.result, spec.accepted / max(spec.drafted, 1)
            else:
                res = llm_model.generate_batched(
                    *args, inference_head_num=head_num, max_tokens=self.max_tokens,
                    cache_len_cap=cap)
        nums, steps = res.num_tokens, res.steps
        llm_time = time.time() - t0

        # ---- stage 2: flow + hift over all rows, at the estimated bucket when
        # every row fits it (the fused rule, for fewer than 4 rows or tight
        # length bounds, engine.py:760-798), else at the realised one ----
        t0 = time.time()
        est_bkt = 0
        if self.fused and (bsz < 4 or all(hi <= max(lo, 1) * 2
                                          for lo, hi in zip(min_lens, max_lens))):
            est_bkt = self._estimate_token_bucket(max(tts_lens), max(min_lens), max(max_lens),
                                                  max(len(r) for r in flow_sp_rows))
        tok_bkt, estimated = self._stage2_bucket(max(lp + n for lp, n in zip(flps, nums)),
                                                 est_bkt)
        flow_dtype = self.flow_params["input_embedding"].dtype
        with torch.profiler.record_function("engine.synth"):
            wav_dev, _ = self._synth_body(
                tok_bkt, pm_bucket, fsp_pad.shape[1], res.tokens, nums,
                self._tensor(fsp_pad, torch.int32), flps,
                self._tensor(pm, flow_dtype), pm_lens,
                self._tensor(emb_rows, torch.float32), noise,
            )
            wavs_np = wav_dev.cpu().numpy().astype(np.float32) / 32767.0
        wavs = [wavs_np[i, :nums[i] * ratio * up] for i in range(bsz)]
        synth_time = time.time() - t0

        total = time.time() - t_start
        dur = sum(len(w) for w in wavs) / cfg.sample_rate
        stats = dict(llm_time=llm_time, synth_time=synth_time, total_time=total,
                     tokens=list(nums), steps=steps, rtf=total / max(dur, 1e-9),
                     token_bucket=tok_bkt, estimated=estimated,
                     spec_acceptance=spec_acceptance)
        logger.info("flash batch x%d: %s tokens in %d steps, rtf=%.4f (llm %.3fs synth %.3fs)",
                    bsz, stats["tokens"], steps, stats["rtf"], llm_time, synth_time)
        return wavs, stats
