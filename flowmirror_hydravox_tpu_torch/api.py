"""Library API over the port's Engine, Frontend and StreamingSynthesizer: a
port of flowmirror_hydravox_tpu/api.py (`HydraVox`, :35-245), itself the
reference's `cli/cosyvoice.py` surface (generators of `{"tts_speech": wav}`
dicts; `stream=True` yields ~1 s chunks).

    from flowmirror_hydravox_tpu_torch.api import HydraVox
    hv = HydraVox(model_dir="weights/")        # device="cuda" by default
    for out in hv.inference_sft("hello world", "default"):
        wav = out["tts_speech"]                 # np.float32 (n,) at 24 kHz

Weights load as the launcher loads them (`{name}.npz`, else the reference's
`{name}.pt`, else random from seed 0). Extra keyword arguments of an
`inference_*` call go to `Engine.synthesize` (or, streamed, to
`StreamingSynthesizer.synthesize_stream`), `noise=` among them.

`spec_decode=True` decodes at two heads or more by self-speculative MTP
verification (JAX :46-48, :95); `quantize="int8"` serves the LLM as
weight-only int8 (JAX :42, :95; ops/quant.py). `prewarm` has no eager
counterpart.
"""

from __future__ import annotations

import logging
import time
from typing import Generator, Optional

import numpy as np
import torch

from .device import resolve_device
from .frontend.frontend import Frontend, SpeakerInfo
from .frontend.tokenizer import get_tokenizer
from .ops.quant import check_mode
from .runtime.engine import Engine

logger = logging.getLogger("hydravox.api")


class HydraVox:
    """CosyVoice-3 / HydraVox synthesis.

    Args:
      model_dir: llm / flow / hift as .npz or .pt; a missing model is random.
      tiny: the tiny smoke config instead of the full sizes.
      quantize: None / "none" / "bf16" (the LLM as loaded) or "int8"
        (weight-only int8 LLM, ops/quant.py); anything else raises ValueError.
      spec_decode: self-speculative MTP verification for every decode at
        two heads or more (heads 1..K-1 draft, head 0 verifies).
      tokenizer_path: an explicit tokenizer asset.
      spk2info: a speaker registry to preload (.npz or the reference's .pt).
      max_tokens: the decode's token cap.
      dtype: the LLM's and flow's dtype (bf16 to serve; HiFT stays f32).
      device: "cuda" (default) or "cpu".
    """

    def __init__(self, model_dir: Optional[str] = None, *, tiny: bool = False,
                 quantize: Optional[str] = None, tokenizer_path: Optional[str] = None,
                 spk2info: Optional[str] = None, max_tokens: int = 1024,
                 dtype=torch.bfloat16, spec_decode: bool = False, device="cuda"):
        from .__main__ import load_models, load_registry

        check_mode(quantize)

        device = resolve_device(device)
        tokenizer = get_tokenizer(tokenizer_path)
        cfg, trees = load_models(tiny, model_dir, tokenizer, device, dtype)
        self.cfg = cfg
        self.engine = Engine(cfg, trees["llm"], trees["flow"], trees["hift"],
                             max_tokens=max_tokens, device=device, spec_decode=spec_decode,
                             quantize=quantize)
        self.frontend = Frontend(cfg, tokenizer=tokenizer, device=device)
        if spk2info:
            load_registry(self.frontend, spk2info)
        if not self.frontend.available_speakers():
            self.frontend.add_speaker("default", SpeakerInfo(embedding=np.zeros(192, np.float32)))
        self.sample_rate = cfg.sample_rate

    # -- speaker management (cli/cosyvoice.py:55-75) -------------------------

    def list_available_spks(self):
        return self.frontend.available_speakers()

    def add_zero_shot_spk(self, prompt_text: str, prompt_wav: np.ndarray, sample_rate: int,
                          zero_shot_spk_id: str) -> bool:
        self.frontend.add_speaker_from_audio(zero_shot_spk_id, prompt_wav, sample_rate,
                                             prompt_text=prompt_text)
        return True

    def save_spkinfo(self, path: str = "spk2info.npz"):
        self.frontend.save_spk2info(path)

    # -- inference generators (cli/cosyvoice.py:77-238) ----------------------

    def _segments(self, tts_text: str, text_frontend: bool = True):
        """`text_frontend=False` skips normalisation and splitting
        (cli/frontend.py:124-131)."""
        return self.frontend.text_normalize(tts_text, split=True) if text_frontend else [tts_text]

    def inference_sft(self, tts_text: str, spk_id: str, stream: bool = False,
                      speed: float = 1.0, text_frontend: bool = True,
                      **kw) -> Generator[dict, None, None]:
        for seg in self._segments(tts_text, text_frontend):
            yield from self._run(self.frontend.frontend_sft(seg, spk_id), stream=stream,
                                 speed=speed, **kw)

    def inference_zero_shot(self, tts_text: str, prompt_text: str, prompt_wav: np.ndarray,
                            sample_rate: int, zero_shot_spk_id: str = "", stream: bool = False,
                            speed: float = 1.0, text_frontend: bool = True,
                            **kw) -> Generator[dict, None, None]:
        """With `zero_shot_spk_id`, a registered speaker's stored prompt text,
        speech tokens and mel; else the prompt audio's."""
        sampling = self.cfg.zero_shot_sampling
        if zero_shot_spk_id:
            for seg in self._segments(tts_text, text_frontend):
                feats = self.frontend.frontend_zero_shot_registered(seg, zero_shot_spk_id)
                yield from self._run(feats, stream=stream, speed=speed, sampling=sampling, **kw)
            return
        prompt = self.frontend.text_normalize(prompt_text, split=False)[0]
        for seg in self._segments(tts_text, text_frontend):
            feats = self.frontend.frontend_zero_shot(seg, prompt, prompt_wav, sample_rate)
            yield from self._run(feats, stream=stream, speed=speed, sampling=sampling, **kw)

    def inference_cross_lingual(self, tts_text: str, prompt_wav: np.ndarray, sample_rate: int,
                                stream: bool = False, speed: float = 1.0,
                                text_frontend: bool = True, **kw) -> Generator[dict, None, None]:
        for seg in self._segments(tts_text, text_frontend):
            feats = self.frontend.frontend_cross_lingual(seg, prompt_wav, sample_rate)
            yield from self._run(feats, stream=stream, speed=speed,
                                 sampling=self.cfg.zero_shot_sampling, **kw)

    def inference_instruct2(self, tts_text: str, instruct_text: str, prompt_wav: np.ndarray,
                            sample_rate: int, stream: bool = False, speed: float = 1.0,
                            text_frontend: bool = True, **kw) -> Generator[dict, None, None]:
        for seg in self._segments(tts_text, text_frontend):
            feats = self.frontend.frontend_instruct2(seg, instruct_text, prompt_wav, sample_rate)
            yield from self._run(feats, stream=stream, speed=speed,
                                 sampling=self.cfg.zero_shot_sampling, **kw)

    def inference_instruct(self, tts_text: str, spk_id: str, instruct_text: str,
                           stream: bool = False, speed: float = 1.0, text_frontend: bool = True,
                           **kw) -> Generator[dict, None, None]:
        for seg in self._segments(tts_text, text_frontend):
            feats = self.frontend.frontend_instruct(seg, spk_id, instruct_text)
            yield from self._run(feats, stream=stream, speed=speed, **kw)

    def inference_vc(self, source_wav: np.ndarray, source_sr: int, prompt_wav: np.ndarray,
                     prompt_sr: int, **kw) -> Generator[dict, None, None]:
        feats = self.frontend.frontend_vc(source_wav, source_sr, prompt_wav, prompt_sr)
        t0 = time.time()
        audio = self.engine.voice_convert(feats["source_speech_tokens"],
                                          feats["prompt_speech_tokens"], feats["prompt_mel"],
                                          feats["spk_embedding"], **kw)
        self._log_rtf(audio, time.time() - t0)
        yield {"tts_speech": audio, "sample_rate": self.sample_rate}

    # -- internals ------------------------------------------------------------

    def _run(self, feats: dict, *, stream: bool, speed: float = 1.0, sampling=None,
             inference_head_num: Optional[int] = None, **kw) -> Generator[dict, None, None]:
        """One segment: streamed at speed 1 when its LM prefix is the flow's
        prompt (the streamer takes no override), else whole."""
        head_num = inference_head_num or self.cfg.llm.inference_head_num
        common = dict(text_tokens=feats["text_tokens"], tts_text_len=feats["tts_text_len"],
                      sampling=sampling, inference_head_num=head_num,
                      prompt_speech_tokens=feats.get("prompt_speech_tokens"),
                      prompt_mel=feats.get("prompt_mel"), spk_embedding=feats.get("spk_embedding"))
        t0 = time.time()
        if stream and speed == 1.0 and feats.get("llm_prompt_speech_tokens") is None:
            for chunk in self.engine.streaming().synthesize_stream(**common, **kw):
                logger.info("yield chunk %.3fs after start", time.time() - t0)
                yield {"tts_speech": chunk, "sample_rate": self.sample_rate}
            return
        res = self.engine.synthesize(
            **common, speed=speed,
            llm_prompt_speech_tokens=feats.get("llm_prompt_speech_tokens"), **kw)
        self._log_rtf(res.audio, time.time() - t0)
        yield {"tts_speech": res.audio, "sample_rate": self.sample_rate}

    def _log_rtf(self, audio: np.ndarray, dt: float):
        dur = len(audio) / self.sample_rate
        if dur > 0:
            logger.info("rtf %.4f (%.2fs audio in %.2fs)", dt / dur, dur, dt)


# HydraVox is the CosyVoice-3 generation (cli/cosyvoice.py:172)
CosyVoice3 = HydraVox
