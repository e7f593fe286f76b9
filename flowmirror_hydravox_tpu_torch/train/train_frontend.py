"""Frontend-model training, the FSQ speech tokenizer and the speaker encoder:
port of flowmirror_hydravox_tpu/train/train_frontend.py.

The reference ships these extractors only as frozen ONNX graphs
(speech_tokenizer_v3.onnx, campplus.onnx) and has no training path for
them; this CLI trains the stand-in architectures on a wav directory or on
the synthetic corpora.

  # self-supervised FSQ tokenizer: mel autoencoding through the bottleneck
  python -m flowmirror_hydravox_tpu_torch.train.train_frontend --model tokenizer \\
      --wav_dir data/wavs --output_dir ckpt/tokenizer [--device cuda|cpu]

  # speaker encoder: AAM-softmax speaker classification (a dir per speaker)
  python -m flowmirror_hydravox_tpu_torch.train.train_frontend --model speaker \\
      --wav_dir data/speakers --output_dir ckpt/speaker

The flags are the JAX trainer's plus `--device` (default cuda; it raises
without a GPU). The batches are the JAX trainer's, byte for byte (numpy, on
a host thread ahead of the step), and so is `--augment`; the initial trees
are drawn from a `torch.Generator` seeded with `--seed`. The tokenizer
trains on the whisper log-mel, the speaker encoder on `kaldi_fbank`
features (as in JAX; the Frontend serves it on `mel_spectrogram`
features). The optimizer is JAX's `steps.make_optimizer` (clip 1.0, AdamW
with weight decay 0.01, warmup-cosine with the warmup clamped to
`max_steps // 2`), the port's `Optimizer` at its defaults, except that an
update whose gradient norm is not finite is skipped.

`_save` writes `<model>.npz` (the encoder / speaker subtree, fp16 under
`--preset shipped`), `<model>_full.npz` (the whole tree, f32) and the
`<model>.json` architecture sidecar, so the port's `Frontend` and the JAX
package's load them (HYDRAVOX_TOKENIZER_NPZ / HYDRAVOX_SPEAKER_NPZ).

One difference from JAX: a wav directory with fewer usable clips than one
batch raises ValueError naming the count, where the JAX batchers loop
forever without yielding.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import logging
import os
import time

import numpy as np
import torch

logger = logging.getLogger("hydravox.train_frontend")


# Copied from flowmirror_hydravox_tpu/train/train_frontend.py (iter_wavs,
# _resample_16k, _synthetic_batches; the batchers' order and draws are JAX's).
def iter_wavs(wav_dir: str):
    """Yield (path, wav float32 mono, sample_rate) for every .wav under dir."""
    from ..utils.wavio import decode_wav

    for path in sorted(glob.glob(os.path.join(wav_dir, "**", "*.wav"), recursive=True)):
        try:
            wav, sr = decode_wav(open(path, "rb").read())
            yield path, wav, sr
        except Exception as e:  # skip unreadable files, keep training
            logger.warning("skipping %s (%s)", path, e)


def _resample_16k(wav: np.ndarray, sr: int) -> np.ndarray:
    if sr == 16000:
        return wav
    n = int(len(wav) * 16000 / sr)
    src = np.linspace(0, len(wav) - 1, n)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, len(wav) - 1)
    w = (src - lo).astype(np.float32)
    return (wav[lo] * (1 - w) + wav[hi] * w).astype(np.float32)


def _synthetic_batches(batch_size: int, seconds: float, n_speakers: int, seed: int):
    """Random-audio batches for smoke runs (no data needed)."""
    rng = np.random.default_rng(seed)
    n = int(16000 * seconds)
    while True:
        spk = rng.integers(0, n_speakers, batch_size)
        # give each "speaker" a distinct spectral tilt so the classification
        # smoke objective is learnable
        t = np.arange(n) / 16000.0
        wavs = np.stack([
            0.1 * np.sin(2 * np.pi * (120 + 60 * s) * t)
            + 0.02 * rng.standard_normal(n)
            for s in spk
        ]).astype(np.float32)
        yield wavs, spk.astype(np.int32)


def _too_few(wav_dir: str, usable: int, batch_size: int) -> ValueError:
    return ValueError(f"{wav_dir} holds {usable} usable clips, fewer than one batch of "
                      f"{batch_size}")


def _wav_batches(wav_dir: str, batch_size: int, seconds: float, seed: int, epochs=None):
    """Tokenizer data: fixed-length 16 kHz crops from a wav directory. Ends
    at once on an empty directory (and, as in JAX, after the first epoch
    when that epoch fills its last batch exactly); with no epoch limit,
    raises ValueError when the first epoch yields no batch."""
    n = int(16000 * seconds)
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        buf, yielded = [], 0
        for _, wav, sr in iter_wavs(wav_dir):
            wav = _resample_16k(wav, sr)
            if len(wav) < n:
                wav = np.pad(wav, (0, n - len(wav)))
            start = rng.integers(0, max(len(wav) - n, 1))
            buf.append(wav[start:start + n])
            if len(buf) == batch_size:
                yield np.stack(buf), None
                buf, yielded = [], yielded + 1
        epoch += 1
        if not buf and epoch == 1 and epochs is None:
            # empty dir: nothing to train on
            return
        if epoch == 1 and not yielded and epochs is None:  # JAX would spin here
            raise _too_few(wav_dir, len(buf), batch_size)


def _speaker_batches(wav_dir: str, batch_size: int, seconds: float, seed: int, epochs=None):
    """Speaker data: subdirectory name = speaker label. With no epoch
    limit, raises ValueError when the directory holds fewer files than one
    batch (none: ends)."""
    from ..utils.wavio import decode_wav

    n = int(16000 * seconds)
    rng = np.random.default_rng(seed)
    files = sorted(glob.glob(os.path.join(wav_dir, "*", "*.wav")))
    speakers = sorted({os.path.basename(os.path.dirname(f)) for f in files})
    spk_id = {s: i for i, s in enumerate(speakers)}
    if not files:
        return
    if len(files) < batch_size and epochs is None:  # JAX would spin here
        raise _too_few(wav_dir, len(files), batch_size)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(files))
        buf, labels = [], []
        for idx in order:
            wav, sr = decode_wav(open(files[idx], "rb").read())
            wav = _resample_16k(wav, sr)
            if len(wav) < n:
                wav = np.pad(wav, (0, n - len(wav)))
            start = rng.integers(0, max(len(wav) - n, 1))
            buf.append(wav[start:start + n])
            labels.append(spk_id[os.path.basename(os.path.dirname(files[idx]))])
            if len(buf) == batch_size:
                yield np.stack(buf), np.asarray(labels, np.int32)
                buf, labels = [], []
        epoch += 1


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=["tokenizer", "speaker"], required=True)
    p.add_argument("--wav_dir", default=None,
                   help="wav directory (speaker mode: one subdir per speaker)")
    p.add_argument("--synthetic", action="store_true",
                   help="random-audio smoke mode (no data needed)")
    p.add_argument("--synthetic_speech", action="store_true",
                   help="deterministic formant-synthesis corpus "
                        "(train/synth_speech.py); the shipped checkpoints' recipe")
    p.add_argument("--corpus_utts", type=int, default=0,
                   help="synthetic_speech: pre-generate this many cached "
                        "utterances and sample crops (0 = stream fresh ones)")
    p.add_argument("--preset", choices=["reference", "shipped"], default="reference",
                   help="'shipped' = the mid-size config of the committed "
                        "checkpoints (fp16 on disk)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--seconds", type=float, default=4.0, help="crop length")
    p.add_argument("--n_speakers", type=int, default=8,
                   help="speaker-count cap (synthetic mode / classifier size)")
    p.add_argument("--learning_rate", type=float, default=3e-4)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--max_steps", type=int, default=50_000)
    p.add_argument("--logging_steps", type=int, default=50)
    p.add_argument("--save_steps", type=int, default=2000)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--tiny", action="store_true", help="tiny config (smoke)")
    p.add_argument("--augment", action="store_true",
                   help="label-preserving recording-channel augmentation "
                        "(reverb/noise/EQ/level, train/augment.py)")
    p.add_argument("--augment_prob", type=float, default=0.5,
                   help="per-crop probability of augmenting (the rest stay clean views)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def model_config(args):
    """The extractor config of `--model`, `--tiny` and `--preset`."""
    from ..frontend import speech_tokenizer as st

    if args.model == "speaker":
        return st.SpeakerEncoderConfig(dim=32, num_layers=2) if args.tiny \
            else st.SpeakerEncoderConfig()
    if args.tiny:
        return st.SpeechTokenizerConfig(dim=64, num_layers=2, num_heads=4)
    if args.preset == "shipped":
        return st.SpeechTokenizerConfig(dim=256, num_layers=4, num_heads=4)
    return st.SpeechTokenizerConfig()


def init_tree(args, cfg, device) -> dict:
    """The training tree: {"enc", "dec"} or {"spk", "classifier"} (a
    (n_speakers, 192) N(0, 0.05) matrix), from a generator seeded with
    `--seed`."""
    from ..frontend import speech_tokenizer as st

    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.model == "tokenizer":
        return {"enc": st.init_tokenizer_params(cfg, gen, device),
                "dec": st.init_decoder_params(cfg, gen, device)}
    return {"spk": st.init_speaker_params(cfg, gen, device),
            "classifier": torch.randn((args.n_speakers, cfg.embed_dim), generator=gen,
                                      device=device) * 0.05}


def loss_fn(model: str, cfg):
    """`(params, batch) -> (loss, metrics)` of `model`: the tokenizer's
    reconstruction MSE on the whisper log-mel of `batch["wavs"]`, or the
    speaker encoder's AAM-softmax loss (and accuracy) on its kaldi fbank."""
    from ..frontend import speech_tokenizer as st
    from ..utils.audio import kaldi_fbank, whisper_log_mel

    if model == "tokenizer":
        def tokenizer_loss(params, batch):
            mel = whisper_log_mel(batch["wavs"], n_mels=cfg.n_mels)
            return st.tokenizer_recon_loss(params["enc"], params["dec"], cfg, mel), {}

        return tokenizer_loss

    def speaker_loss(params, batch):
        feats = kaldi_fbank(batch["wavs"], 16000, cfg.n_mels)
        return speaker_feature_loss(params, cfg, feats, batch["labels"])

    return speaker_loss


def speaker_feature_loss(params, cfg, feats, labels):
    """The speaker encoder's AAM-softmax loss and accuracy on fbank
    features (B, frames, n_mels)."""
    from ..frontend import speech_tokenizer as st

    emb = st.speaker_embedding(params["spk"], cfg, feats.transpose(1, 2))
    loss, acc = st.aam_softmax_loss(emb, params["classifier"], labels)
    return loss, {"acc": acc}


def batch_source(args):
    """The JAX trainer's batches for these flags (train_frontend.py:194-244)."""
    if args.synthetic_speech:
        from .synth_speech import corpus_batches, synth_batches

        batches = (corpus_batches(args.batch_size, args.seconds, args.n_speakers, args.seed,
                                  corpus_utts=args.corpus_utts) if args.corpus_utts
                   else synth_batches(args.batch_size, args.seconds, args.n_speakers, args.seed))
    elif args.synthetic:
        batches = _synthetic_batches(args.batch_size, args.seconds, args.n_speakers, args.seed)
    elif args.model == "tokenizer":
        batches = _wav_batches(args.wav_dir, args.batch_size, args.seconds, args.seed)
    else:
        batches = _speaker_batches(args.wav_dir, args.batch_size, args.seconds, args.seed)
    if args.augment:
        from .augment import augment_batches

        batches = augment_batches(batches, seed=args.seed, prob=args.augment_prob)
    return batches


def main(argv=None, on_step=None):
    """Train and save; returns the final `TrainState`. `on_step(state,
    metrics)` runs after each step (chip_smoke.py times steps with it)."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from .cli import train_device
    from .data import Prefetch
    from .steps import OptimConfig, Optimizer, batch_to, init_state, loss_train_step

    device = train_device(args)
    os.makedirs(args.output_dir, exist_ok=True)
    cfg = model_config(args)
    opt = Optimizer(OptimConfig(learning_rate=args.learning_rate,
                                warmup_steps=args.warmup_steps, total_steps=args.max_steps))
    state = init_state(init_tree(args, cfg, device), opt)
    fn = loss_fn(args.model, cfg)

    t0 = time.time()
    with Prefetch(batch_source(args)) as batches:
        for i, (wavs, labels) in enumerate(batches):
            if i >= args.max_steps:
                break
            batch = {"wavs": wavs} if args.model == "tokenizer" else \
                {"wavs": wavs, "labels": labels}
            state, metrics = loss_train_step(state, batch_to(batch, device), fn, opt)
            if on_step is not None:
                on_step(state, metrics)
            if (i + 1) % args.logging_steps == 0 or i == 0:
                m = {k: float(v) for k, v in metrics.items() if k != "grad_norm"}
                logger.info("step %d %s (%.1fs)", i + 1, m, time.time() - t0)
            if (i + 1) % args.save_steps == 0:
                _save(args, state, cfg)
    _save(args, state, cfg)
    logger.info("done: %s", args.output_dir)
    return state


def _save(args, state, cfg):
    """`<model>.npz` = the subtree the serving Frontend reads (encoder /
    speaker trunk), fp16 under `--preset shipped`; `<model>_full.npz` = the
    whole training tree; `<model>.json` = the config sidecar."""
    from .checkpoint import save_params_npz

    tree = state.params["enc"] if args.model == "tokenizer" else state.params["spk"]
    save_params_npz(os.path.join(args.output_dir, f"{args.model}.npz"), tree,
                    np.float16 if args.preset == "shipped" else None)
    save_params_npz(os.path.join(args.output_dir, f"{args.model}_full.npz"), state.params)
    cfg_dict = {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in dataclasses.asdict(cfg).items()}
    with open(os.path.join(args.output_dir, f"{args.model}.json"), "w") as f:
        json.dump(cfg_dict, f, indent=1)


if __name__ == "__main__":
    main()
