"""Chunked streaming synthesis: a port of
flowmirror_hydravox_tpu/runtime/streaming.py (reference cli/model.py:236-360,
token2wav and tts).

  - A 25-token hop (1 s of audio) plus pre_lookahead_len = 3 lookahead tokens
    per chunk; the first chunk also takes the prompt tokens' padding to a hop
    multiple (`prompt_pad`).
  - Each chunk runs the flow over the whole token prefix with the streaming
    (static-chunk) attention mask and keeps the frames from
    token_offset * token_mel_ratio on; the chunk's mel is edge-replicated to
    its `_bucket_chunk` size. HiFT is non-causal, so that padding and the
    token bucket shape the wav: the JAX ladders are kept.
  - HiFT seams: the last 8 mel frames and 8 x 480 source samples of a chunk
    are carried into the next, whose source is spliced with them, and a
    Hamming window cross-fades consecutive waveforms (`fade_in_out`).
  - The first chunk's output rule: when the first chunk's target is not cut
    by max_len, the JAX streamer fuses the prefill, the decode to it and its
    flow and HiFT into one program that returns int16 PCM, so that chunk and
    its cross-fade cache pass through int16 and back (streaming.py:334-365).
    One dispatch buys the eager port nothing; it keeps the output rule.

The LM is the resumable decode of models/llm.py (`init_generate_state`, then
`generate_until` each chunk's target; on an engine that speculates at the
request's heads, `init_spec_state`, then `generate_spec_until`, JAX `_spec`
and `_decode_init_until` :62-100), through both Hopper kernels on the card.
Pausing at a chunk target changes no draw, so a stream's tokens equal a
one-shot decode's. A session draws from a `noise.StreamNoise`
(`Engine.stream_noise`): the decode draws continue from chunk to chunk, and
every chunk's NSF source redraws from the one vocoder key, as the JAX
streamer reuses `hift_rng`.

Not ported: the jit caches and `prewarm_ladder` (:408-466), which pay for
XLA compiles and have no eager counterpart.
"""

from __future__ import annotations

import time
from typing import Generator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models import flow as flow_model
from ..models import hift as hift_model
from ..models import llm as llm_model
from ..ops.sampling import SamplingParams
from .engine import MAX_TOKEN_TEXT_RATIO, MIN_TOKEN_TEXT_RATIO, TOKEN_BUCKETS, _bucket


def fade_in_out(fade_in: np.ndarray, fade_out: np.ndarray, window: np.ndarray) -> np.ndarray:
    """Hamming cross-fade (reference common.py:169-177)."""
    n = window.shape[0] // 2
    out = fade_in.copy()
    out[..., :n] = fade_in[..., :n] * window[:n] + fade_out[..., -n:] * window[n:]
    return out


def _bucket_chunk(n: int) -> int:
    for b in (64, 128, 256, 512, 1024, 2048):
        if n <= b:
            return b
    return 2048


class StreamingSynthesizer:
    """Streaming sessions over an Engine's parameters; holds no per-session
    state, so one instance serves every concurrent stream."""

    def __init__(self, engine, token_hop_len: int = 25, mel_cache_len: int = 8):
        self.engine = engine
        self.cfg = engine.cfg
        self.token_hop_len = token_hop_len
        self.mel_cache_len = mel_cache_len
        self.source_cache_len = mel_cache_len * self.cfg.hift.upsample_scale
        self.speech_window = np.hamming(2 * self.source_cache_len)

    @torch.inference_mode()
    def synthesize_stream(
        self,
        text_tokens: np.ndarray,
        tts_text_len: int,
        sampling=None,
        inference_head_num: Optional[int] = None,
        prompt_speech_tokens: Optional[np.ndarray] = None,
        prompt_mel: Optional[np.ndarray] = None,
        spk_embedding: Optional[np.ndarray] = None,
        noise=None,
        max_token_text_ratio: float = MAX_TOKEN_TEXT_RATIO,
        min_token_text_ratio: float = MIN_TOKEN_TEXT_RATIO,
        session: Optional[dict] = None,
    ) -> Generator[np.ndarray, None, None]:
        """Yields 24 kHz float32 waveform chunks (~1 s each). `noise`
        (default `Engine.stream_noise()`) is a StreamNoise. A `session` dict,
        when given, receives the speech tokens, the decode steps and
        seconds (`decode_s`), each chunk's synthesis seconds and samples
        (`chunks`), and, when the decode speculates, its `spec_acceptance`."""
        engine, cfg = self.engine, self.cfg
        sampling = sampling or cfg.tts_sampling
        head_num = inference_head_num or cfg.llm.inference_head_num
        noise = noise if noise is not None else engine.stream_noise()
        emb = (np.zeros((192,), np.float32) if spk_embedding is None
               else np.asarray(spk_embedding, np.float32).reshape(-1)[:192])
        text_pad, lt, tts_text_len = engine._text_row(text_tokens, tts_text_len)
        sp_pad, lp, _, _ = engine._row_prompts(prompt_speech_tokens, prompt_mel)
        prompt_tokens = sp_pad[:lp]
        min_len = int(tts_text_len * min_token_text_ratio)
        max_len = min(int(tts_text_len * max_token_text_ratio), engine.max_tokens)
        sp = SamplingParams.make(sampling.top_p, sampling.top_k, sampling.win_size, sampling.tau_r)
        session = {} if session is None else session
        session.update(tokens=[], steps=0, chunks=[], decode_s=0.0)

        la = cfg.flow.pre_lookahead_len
        hop = self.token_hop_len
        prompt_pad = -lp % hop  # the first chunk ends on a hop multiple
        first_hop = hop + prompt_pad
        first_target = min(first_hop + la, max_len)

        spec = engine.speculates(head_num)
        state = engine._prefill(text_pad, lt, sp_pad, lp, head_num, min_len, max_len, sp, noise)

        def progress():
            """(tokens (L,), num, finished) of either decode's state."""
            if spec:
                return state["tokens"][0], state["num"][0], state["finished"][0]
            return state["tokens"], state["num"], state["finished"]

        def decode_to(target):
            t0 = time.time()
            if spec:
                llm_model.generate_spec_until(engine.llm_params, cfg.llm, state, target, sp,
                                              noise, num_heads=head_num)
            else:
                llm_model.generate_until(engine.llm_params, cfg.llm, state, target, min_len,
                                         max_len, sp, noise, inference_head_num=head_num)
            tokens, n, finished = progress()
            out = tokens[:n].cpu().numpy()
            session["decode_s"] += time.time() - t0
            return out, finished or n >= max_len

        def chunk(tokens, token_offset, finalize, hift_cache, quantize=False):
            t0 = time.time()
            wav, cache = self._token2wav(tokens, prompt_tokens, prompt_mel, emb, token_offset,
                                         noise, finalize, hift_cache, quantize)
            session["chunks"].append((time.time() - t0, len(wav)))
            return wav, cache

        try:
            produced, finished = decode_to(first_target)
            token_offset, hift_cache = 0, None
            if first_target == first_hop + la and len(produced) >= first_target:
                # the JAX fused first chunk: its wav passes through int16
                wav, hift_cache = chunk(produced[:first_target], 0, False, None, quantize=True)
                token_offset = first_hop
                yield wav
            while True:
                this_hop = first_hop if token_offset == 0 else hop
                target = token_offset + this_hop + la
                if not finished and len(produced) < target:
                    produced, finished = decode_to(min(target, max_len))
                if len(produced) - token_offset >= this_hop + la:
                    wav, hift_cache = chunk(produced[:target], token_offset, False, hift_cache)
                    token_offset += this_hop
                    yield wav
                    continue
                if finished:
                    break
            wav, _ = chunk(produced, token_offset, True, hift_cache)  # the final flush
            yield wav
        finally:
            tokens, n, _ = progress()
            session.update(tokens=tokens[:n].tolist(), steps=state["steps"])
            if spec:
                session["spec_acceptance"] = state["accepted"][0] / max(state["drafted"][0], 1)

    def _token2wav(self, tokens, prompt_tokens, prompt_mel, spk_embedding, token_offset: int,
                   noise, finalize: bool, hift_cache, quantize: bool = False):
        """One chunk (streaming.py:468-539): flow over the prompt tokens +
        `tokens` (the generated prefix) at a TOKEN_BUCKETS size, the chunk's
        frames from `token_offset` on, HiFT with the carried cache, the
        cross-fade. `quantize` passes the wav through int16 (the fused first
        chunk's rule). Returns (wav float32, the next chunk's cache or None
        after the final flush)."""
        eng, cfg = self.engine, self.cfg
        ratio, la = cfg.flow.token_mel_ratio, cfg.flow.pre_lookahead_len
        hcfg = cfg.hift
        up = hcfg.upsample_scale
        mc, sc = self.mel_cache_len, self.source_cache_len
        dev = eng.device

        _, _, pm, pm_len = eng._row_prompts(None, prompt_mel)
        all_tokens = np.concatenate([np.asarray(prompt_tokens, np.int32),
                                     np.asarray(tokens, np.int32)])
        n_all = len(all_tokens)
        n_emit = n_all - (0 if finalize else la)
        tbucket = _bucket(max(n_all, 1), TOKEN_BUCKETS)
        tok = torch.zeros((1, tbucket), dtype=torch.int32, device=dev)
        tok[0, :n_all] = torch.as_tensor(all_tokens, device=dev)
        pos = torch.arange(tbucket, device=dev)[None]
        flow_dtype = eng.flow_params["input_embedding"].dtype
        mel_full = flow_model.inference(
            eng.flow_params, cfg.flow, tok, pos < n_all, eng._tensor(pm, flow_dtype), pm_len,
            eng._tensor(spk_embedding[None], torch.float32), finalize=finalize, streaming=True,
            emit_valid=None if finalize else pos < n_emit,
        )  # (1, 80, tbucket * ratio) f32

        # the frames this chunk emits (generated tokens only; when not
        # finalizing, the lookahead is conv context), edge-replicated to the
        # chunk's bucket for the f0 convs at the boundary
        n_frames = max((len(tokens) - (0 if finalize else la) - token_offset) * ratio, 0)
        chunk_bucket = _bucket_chunk(max(n_frames, 1))
        mel_pad = F.pad(mel_full, (0, chunk_bucket))
        src = pm_len + token_offset * ratio + torch.clamp(
            torch.arange(chunk_bucket, device=dev), max=max(n_frames - 1, 0))
        mel_chunk = mel_pad[:, :, src]

        has_cache = hift_cache is not None
        mel_in = torch.cat([hift_cache["mel"], mel_chunk], dim=2) if has_cache else mel_chunk
        hp = eng.hift_params
        f0 = hift_model.predict_f0(hp, mel_in)
        f0_up = torch.repeat_interleave(f0, up, dim=-1)[..., None]
        rand_ini, src_noise = noise.vocoder(1, f0_up.shape[1], hcfg.nb_harmonics + 1)
        s, _ = hift_model.sine_source(hcfg, f0_up, rand_ini, src_noise)
        source = torch.tanh(hift_model.linear(hp["m_source_linear"], s)).transpose(1, 2)
        if has_cache:
            source = torch.cat([hift_cache["source"], source[:, :, sc:]], dim=2)
        wav_dev = hift_model.decode(hp, hcfg, mel_in, source)

        total_frames = (mc if has_cache else 0) + n_frames
        wav_dev = wav_dev[0, :total_frames * up]
        if quantize:
            wav = (torch.clamp(wav_dev, -1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy()
            wav = wav.astype(np.float32) / 32767.0
        else:
            wav = wav_dev.float().cpu().numpy()
        new_cache = None if finalize else {  # the speech cache is taken before the fade
            "mel": mel_in[:, :, total_frames - mc:total_frames],
            "source": source[:, :, total_frames * up - sc:total_frames * up],
            "speech": wav[-sc:],
        }
        if has_cache:
            wav = fade_in_out(wav, hift_cache["speech"], self.speech_window)
        return (wav, None) if finalize else (wav[:-sc], new_cache)
