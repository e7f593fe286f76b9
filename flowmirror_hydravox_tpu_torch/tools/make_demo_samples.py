# Copied from flowmirror_hydravox_tpu/tools/make_demo_samples.py (numpy; the same bytes).
"""Generate the demo reference-sample set (assets/samples/).

The reference repo ships demo prompt clips with transcripts under
assets/samples/<set>/<speaker>/ that its UI's reference-sample browser
offers for zero-shot cloning (user_interface/tabs/inference_tab.py:14-18).
Those recordings are third-party audio, so this repo ships a small
deterministic synthetic set instead: formant-synthesized speakers from
train/synth_speech.py (seeded, identical bytes on every machine, and the
JAX package's bytes).

    python -m flowmirror_hydravox_tpu_torch.tools.make_demo_samples [--root DIR]

The default root is the repository's committed set, `assets/samples`: write
anywhere else to leave it as it is.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..train.synth_speech import SR, synth_utterance
from ..utils import wavio

# (set, speaker, clip index -> utterance id, transcript)
_CLIPS = [
    ("synthetic_voices", "speaker_a", 0, "A bright higher register voice, clip one."),
    ("synthetic_voices", "speaker_a", 1, "A bright higher register voice, clip two."),
    ("synthetic_voices", "speaker_b", 0, "A lower darker register voice, clip one."),
    ("synthetic_voices", "speaker_b", 1, "A lower darker register voice, clip two."),
]
_SPEAKER_IDS = {"speaker_a": 3, "speaker_b": 11}


def generate(root: str = "assets/samples", seconds: float = 3.0) -> list:
    written = []
    for set_name, spk, utt_id, text in _CLIPS:
        d = os.path.join(root, set_name, spk)
        os.makedirs(d, exist_ok=True)
        wav = synth_utterance(_SPEAKER_IDS[spk], utt_id, seconds=seconds)
        wav = (wav / max(1e-6, np.abs(wav).max()) * 0.7).astype(np.float32)
        base = os.path.join(d, f"{spk}_{utt_id + 1}")
        with open(base + ".wav", "wb") as f:
            f.write(wavio.encode_wav(wav, SR))
        with open(base + ".txt", "w", encoding="utf-8") as f:
            f.write(text + "\n")
        written.append(base + ".wav")
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--root", default="assets/samples")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    for path in generate(args.root, args.seconds):
        print(path)


if __name__ == "__main__":
    main()
