"""Frontend (port of flowmirror_hydravox_tpu/frontend/frontend.py; reference
cli/frontend.py:39-219): text normalisation and splitting, text tokens, the
speaker registry, and zero-shot prompt featurisation: speech tokens (the FSQ
tokenizer), the 24 kHz prompt mel and the speaker embedding, with the
reference's 30 s prompt cap and 1:2 token:mel trim.

The extractors run on the frontend's device (the card unless the caller asks
for the CPU). Their weights resolve as the JAX frontend resolves them
(frontend.py:60-130): explicit parameter trees, then the
HYDRAVOX_TOKENIZER_NPZ / HYDRAVOX_SPEAKER_NPZ files, then the committed
checkpoints under assets/ckpt/ (byte-identical copies of the JAX package's,
each with its `.json` architecture sidecar). Where the JAX frontend falls
back to a random init, the port raises: it cannot draw the JAX init, and
zero-shot conditioning on noise would pass unnoticed.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import HydraVoxConfig
from ..device import resolve_device
from ..params import flatten_params, from_numpy_tree, load_params_npz
from ..utils import audio, hf_dataset
from . import speech_tokenizer as st
from .text_norm import normalize, split_text_by_punctuation
from .tokenizer import get_tokenizer

ASSET_DIR = os.path.join(os.path.dirname(__file__), "assets", "ckpt")
PROMPT_CAP_S = 30  # cli/frontend.py:94
TOKEN_FRAME = 640  # 16 kHz samples per 25 Hz speech token

# Built-in instruct prompts (reference cosyvoice/utils/common.py:28-53):
# dialect/emotion/style control strings ending in <|endofprompt|>.
INSTRUCT_PROMPTS = [
    *[f"You are a helpful assistant. 请用{d}表达。<|endofprompt|>" for d in (
        "广东话", "东北话", "甘肃话", "贵州话", "河南话", "湖北话", "湖南话",
        "江西话", "闽南话", "宁夏话", "山西话", "陕西话", "山东话", "上海话",
        "四川话", "天津话", "云南话",
    )],
    "You are a helpful assistant. Please say a sentence as loudly as possible.<|endofprompt|>",
    "You are a helpful assistant. Please say a sentence in a very soft voice.<|endofprompt|>",
    "You are a helpful assistant. 请用尽可能慢地语速说一句话。<|endofprompt|>",
    "You are a helpful assistant. 请用尽可能快地语速说一句话。<|endofprompt|>",
    "You are a helpful assistant. 请非常开心地说一句话。<|endofprompt|>",
    "You are a helpful assistant. 请非常伤心地说一句话。<|endofprompt|>",
    "You are a helpful assistant. 请非常生气地说一句话。<|endofprompt|>",
    "You are a helpful assistant. 我想体验一下小猪佩奇风格，可以吗？<|endofprompt|>",
    "You are a helpful assistant. 你可以尝试用机器人的方式解答吗？<|endofprompt|>",
]


@dataclasses.dataclass
class SpeakerInfo:
    embedding: np.ndarray  # (192,)
    prompt_text: Optional[np.ndarray] = None  # (Lt,) tokens
    prompt_speech_tokens: Optional[np.ndarray] = None  # (Lp,)
    prompt_mel: Optional[np.ndarray] = None  # (Lm, 80)


def load_extractor_cfg(npz_path: str, name: str):
    """The `<name>.json` architecture sidecar beside an extractor npz
    (frontend.py:131-150); None when there is none."""
    sidecar = os.path.join(os.path.dirname(npz_path), f"{name}.json")
    if not os.path.exists(sidecar):
        return None
    with open(sidecar) as f:
        d = json.load(f)
    if name == "tokenizer":
        if "fsq_levels" in d:
            d["fsq_levels"] = tuple(d["fsq_levels"])
        return st.SpeechTokenizerConfig(**d)
    return st.SpeakerEncoderConfig(**d)


def load_extractor(name: str, device, path: Optional[str] = None):
    """(config, f32 tree on `device`) of the `name` extractor ("tokenizer" or
    "speaker") from `path`, else HYDRAVOX_<NAME>_NPZ, else the committed
    checkpoint; the config is the `.json` sidecar beside the file, else the
    default. Raises when no weights resolve or the file lacks a leaf."""
    if path is None:
        env_path = os.environ.get(f"HYDRAVOX_{name.upper()}_NPZ")
        path = (env_path if env_path and os.path.exists(env_path)
                else os.path.join(ASSET_DIR, f"{name}.npz"))
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {name} extractor weights at {path}")
    cfg = load_extractor_cfg(path, name) or (
        st.SpeechTokenizerConfig() if name == "tokenizer" else st.SpeakerEncoderConfig())
    tree = load_params_npz(path, device, torch.float32)
    missing = st.expected_keys(cfg) - set(flatten_params(tree))
    if missing:
        raise KeyError(f"{path} lacks {sorted(missing)}")
    return cfg, tree


class Frontend:
    def __init__(self, cfg: HydraVoxConfig, tokenizer=None, tokenizer_params=None,
                 speaker_params=None, device="cuda"):
        """`tokenizer_params` / `speaker_params`: numpy trees in the JAX
        layout, run with the default extractor configs (the caller owns the
        match, as in the JAX frontend)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.tokenizer = tokenizer or get_tokenizer()
        self.st_cfg = st.SpeechTokenizerConfig()
        self.spk_cfg = st.SpeakerEncoderConfig()
        self.tokenizer_params = self._extractor("tokenizer", tokenizer_params)
        self.speaker_params = self._extractor("speaker", speaker_params)
        self.spk2info: Dict[str, SpeakerInfo] = {}

    def _extractor(self, name: str, explicit):
        """One extractor's f32 tree on the frontend's device; sets its config
        from the sidecar. Raises when no weights resolve."""
        if explicit is not None:
            return from_numpy_tree(explicit, self.device, torch.float32)
        cfg, tree = load_extractor(name, self.device)
        if name == "tokenizer":
            self.st_cfg = cfg
        else:
            self.spk_cfg = cfg
        return tree

    # -- text ---------------------------------------------------------------

    def text_normalize(self, text: str, split: bool = True) -> List[str]:
        text = normalize(text)
        if not split:
            return [text]
        return split_text_by_punctuation(text) or [text]

    def extract_text_tokens(self, text: str) -> np.ndarray:
        return np.asarray(self.tokenizer.encode(text), np.int32)

    # -- audio --------------------------------------------------------------

    def _wav(self, wav, sample_rate: int, target_sr: int) -> torch.Tensor:
        """A mono prompt as a (1, T) f32 tensor on the device, at target_sr."""
        x = torch.from_numpy(np.ascontiguousarray(np.asarray(wav, np.float32).reshape(-1)))
        return audio.resample_linear(x.to(self.device)[None], sample_rate, target_sr)

    @torch.inference_mode()
    def extract_speech_tokens(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        """Prompt wav -> 25 Hz speech tokens; 30 s cap (cli/frontend.py:94),
        padded with zeros to a whole number of 640-sample token frames."""
        wav = np.asarray(wav, np.float32).reshape(-1)[: sample_rate * PROMPT_CAP_S]
        wav16 = self._wav(wav, sample_rate, 16000)
        wav16 = F.pad(wav16, (0, -wav16.shape[-1] % TOKEN_FRAME))
        toks = st.tokenize_waveform(self.tokenizer_params, self.st_cfg, wav16)
        return toks[0].cpu().numpy()

    @torch.inference_mode()
    def extract_mel(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        """Prompt wav -> 24 kHz 80-bin mel (Lm, 80) (cli/frontend.py:117-123)."""
        m = self.cfg.mel
        wav24 = self._wav(wav, sample_rate, m.sample_rate)
        mel = audio.mel_spectrogram(wav24, m.n_fft, m.num_mels, m.sample_rate, m.hop_size,
                                    m.win_size, m.fmin, m.fmax)
        return mel[0].T.cpu().numpy()

    @torch.inference_mode()
    def extract_spk_embedding(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        wav16 = self._wav(wav, sample_rate, 16000)
        mel = audio.mel_spectrogram(wav16, 400, 80, 16000, 160, 400)
        return st.speaker_embedding(self.speaker_params, self.spk_cfg, mel)[0].cpu().numpy()

    def _prompt_features(self, wav, sample_rate: int):
        """(speech tokens, mel) of a prompt trimmed to exactly 1:2."""
        tokens = self.extract_speech_tokens(wav, sample_rate)
        mel = self.extract_mel(wav, sample_rate)
        n = min(len(tokens), mel.shape[0] // 2)
        return tokens[:n], mel[: 2 * n]

    # -- request assembly ---------------------------------------------------

    def frontend_zero_shot(self, tts_text: str, prompt_text: str, prompt_wav: np.ndarray,
                           sample_rate: int) -> dict:
        """Zero-shot featurisation (cli/frontend.py:163-209)."""
        tts_tokens = self.extract_text_tokens(tts_text)
        prompt_tokens = self.extract_text_tokens(prompt_text)
        speech_tokens, mel = self._prompt_features(prompt_wav, sample_rate)
        return dict(
            text_tokens=np.concatenate([prompt_tokens, tts_tokens]),
            tts_text_len=len(tts_tokens),
            prompt_speech_tokens=speech_tokens,
            prompt_mel=mel,
            spk_embedding=self.extract_spk_embedding(prompt_wav, sample_rate),
        )

    def frontend_cross_lingual(self, tts_text: str, prompt_wav: np.ndarray,
                               sample_rate: int) -> dict:
        """Cross-lingual cloning (cli/frontend.py:186-194): the LM sees no
        prompt text or speech tokens; the flow keeps the prompt's mel, tokens
        and embedding for timbre."""
        feats = self.frontend_zero_shot(tts_text, "", prompt_wav, sample_rate)
        feats["llm_prompt_speech_tokens"] = np.zeros((0,), np.int32)
        feats["text_tokens"] = feats["text_tokens"][-feats["tts_text_len"]:]
        return feats

    def frontend_instruct(self, tts_text: str, spk_id: str, instruct_text: str) -> dict:
        """Instruct mode (cli/frontend.py:196-203): the instruct text becomes
        the prompt text; no prompt speech reaches the LM."""
        feats = self.frontend_sft(tts_text, spk_id)
        instruct_tokens = self.extract_text_tokens(instruct_text)
        feats["text_tokens"] = np.concatenate([instruct_tokens, feats["text_tokens"]])
        feats["llm_prompt_speech_tokens"] = np.zeros((0,), np.int32)
        return feats

    def frontend_instruct2(self, tts_text: str, instruct_text: str, prompt_wav: np.ndarray,
                           sample_rate: int) -> dict:
        """Instruct2 (cli/frontend.py:205-209): zero-shot with the instruct
        text as prompt text, but no prompt speech tokens for the LM."""
        feats = self.frontend_zero_shot(tts_text, instruct_text, prompt_wav, sample_rate)
        feats["llm_prompt_speech_tokens"] = np.zeros((0,), np.int32)
        return feats

    def frontend_vc(self, source_wav: np.ndarray, source_sr: int, prompt_wav: np.ndarray,
                    prompt_sr: int) -> dict:
        """Voice conversion (cli/frontend.py:211-219): the source's speech
        tokens bypass the LM; the flow re-voices them with the prompt's timbre."""
        tokens, mel = self._prompt_features(prompt_wav, prompt_sr)
        return dict(
            source_speech_tokens=self.extract_speech_tokens(source_wav, source_sr),
            prompt_speech_tokens=tokens,
            prompt_mel=mel,
            spk_embedding=self.extract_spk_embedding(prompt_wav, prompt_sr),
        )

    def frontend_sft(self, tts_text: str, spk_id: str) -> dict:
        """Preset-speaker featurisation (cli/frontend.py:157-162)."""
        if spk_id not in self.spk2info:
            raise KeyError(
                f"unknown speaker_id '{spk_id}'; available: {self.available_speakers()}"
            )
        info = self.spk2info[spk_id]
        tokens = self.extract_text_tokens(tts_text)
        return dict(
            text_tokens=tokens,
            tts_text_len=len(tokens),
            prompt_speech_tokens=info.prompt_speech_tokens,
            prompt_mel=info.prompt_mel,
            spk_embedding=info.embedding,
        )

    def frontend_zero_shot_registered(self, tts_text: str, spk_id: str) -> dict:
        """Zero-shot through a registered speaker (cli/frontend.py:163-170):
        its stored prompt text tokens, speech tokens, mel and embedding."""
        feats = self.frontend_sft(tts_text, spk_id)
        info = self.spk2info[spk_id]
        if info.prompt_text is not None and len(info.prompt_text) > 0:
            feats["text_tokens"] = np.concatenate(
                [np.asarray(info.prompt_text, np.int32), feats["text_tokens"]])
        return feats

    # -- speaker registry ---------------------------------------------------

    def add_speaker(self, spk_id: str, info: SpeakerInfo):
        self.spk2info[spk_id] = info

    def available_speakers(self) -> List[str]:
        return sorted(self.spk2info.keys())

    def _prompt_text_tokens(self, prompt_text: Optional[str]):
        return self.extract_text_tokens(prompt_text) if prompt_text else None

    def add_speaker_from_audio(self, spk_id: str, wav: np.ndarray, sample_rate: int,
                               prompt_text: Optional[str] = None):
        """Register a speaker from reference audio: its embedding and
        zero-shot prompt features (speaker_manage.py:268-407)."""
        tokens, mel = self._prompt_features(wav, sample_rate)
        self.spk2info[spk_id] = SpeakerInfo(
            embedding=self.extract_spk_embedding(wav, sample_rate),
            prompt_text=self._prompt_text_tokens(prompt_text),
            prompt_speech_tokens=tokens,
            prompt_mel=mel,
        )

    def remove_speaker(self, spk_id: str) -> bool:
        return self.spk2info.pop(spk_id, None) is not None

    def compute_mean_embedding(self, wavs, sample_rate: int) -> np.ndarray:
        """Mean speaker embedding over several clips (speaker_manage.py:191)."""
        embs = [self.extract_spk_embedding(w, sample_rate) for w in wavs]
        return np.mean(np.stack(embs), axis=0)

    def add_speaker_from_dataset(self, spk_id: str, dataset_dir: str,
                                 prompt_text: Optional[str] = None,
                                 max_rows: int = 5000) -> int:
        """Enrol a speaker as the mean embedding over a Hugging Face dataset
        on disk (speaker_manage.py:191-259): a precomputed 'embedding' column
        if there is one, else one extraction per 'audio' row, sampling 5000
        rows at most (`datasets`' shuffle at seed 42: the JAX frontend's
        rows). Returns the number of rows averaged. The dataset is read by
        utils/hf_dataset.py, not by the `datasets` library."""
        ds = hf_dataset.load_from_disk(dataset_dir)
        cols = ds.column_names
        embs = []
        if "embedding" in cols:
            for row in ds:
                e = row["embedding"]
                if e is None:
                    continue
                embs.append(np.asarray(e, np.float32).reshape(-1))
        elif "audio" in cols:
            if len(ds) > max_rows:
                ds = ds.shuffle(seed=42).select(range(max_rows))
            for row in ds:
                a = row["audio"]
                wav = np.asarray(a["array"], np.float32)
                embs.append(self.extract_spk_embedding(wav, int(a["sampling_rate"])))
        else:
            raise ValueError("dataset needs an 'embedding' or 'audio' column")
        if not embs:
            raise ValueError("no usable rows in dataset")
        self.spk2info[spk_id] = SpeakerInfo(
            embedding=np.mean(np.stack(embs), axis=0),
            prompt_text=self._prompt_text_tokens(prompt_text),
        )
        return len(embs)

    def save_spk2info(self, path: str):
        """Persist the registry as npz (the spk2info.pt equivalent): each
        speaker's embedding, prompt speech tokens and prompt mel."""
        flat = {}
        for spk, info in self.spk2info.items():
            flat[f"{spk}::embedding"] = info.embedding
            if info.prompt_speech_tokens is not None:
                flat[f"{spk}::prompt_speech_tokens"] = info.prompt_speech_tokens
            if info.prompt_mel is not None:
                flat[f"{spk}::prompt_mel"] = info.prompt_mel
        np.savez(path, **flat)

    def load_spk2info_npz(self, path: str):
        with np.load(path) as data:
            by_spk: Dict[str, dict] = {}
            for key in data.files:
                spk, field = key.split("::", 1)
                by_spk.setdefault(spk, {})[field] = data[key]
        for spk, fields in by_spk.items():
            self.spk2info[spk] = SpeakerInfo(
                embedding=fields["embedding"],
                prompt_speech_tokens=fields.get("prompt_speech_tokens"),
                prompt_mel=fields.get("prompt_mel"),
            )

    def load_spk2info(self, path: str):
        """Load a reference spk2info.pt registry (infer_speech_model.py:145-168):
        each entry's `llm_embedding` (or `embedding`), first 192 values."""
        data = torch.load(path, map_location="cpu", weights_only=False)
        for spk, entry in data.items():
            emb = entry.get("llm_embedding", entry.get("embedding"))
            if isinstance(emb, torch.Tensor):
                emb = emb.float().numpy()
            self.spk2info[str(spk)] = SpeakerInfo(
                embedding=np.asarray(emb, np.float32).reshape(-1)[:192],
            )
