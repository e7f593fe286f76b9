# Copied from flowmirror_hydravox_tpu/runtime/samples.py; the port keeps its own copy.
"""Reference-sample browser backend.

The reference UI scans ``assets/samples/`` for prompt wavs with same-stem
``.txt`` transcripts and offers them in the zero-shot tab so users can clone
a voice without uploading audio (user_interface/tabs/inference_tab.py:14-71
scan_reference_samples, :308-334 load_reference_sample).  Here the scan runs
server-side (the browser UI has no filesystem access): GET /api/v1/samples
lists the tree, POST /api/v1/samples/load returns one sample's audio as
base64 plus its transcript.  Root comes from the TTS_SAMPLES_DIR env var
(default "assets/samples"), path containment enforced like models_admin.
"""

from __future__ import annotations

import base64
import os

__all__ = ["samples_root", "list_samples", "load_sample"]


def samples_root() -> str:
    return os.environ.get("TTS_SAMPLES_DIR", "assets/samples")


def _transcript_path(wav_path: str) -> str:
    return os.path.splitext(wav_path)[0] + ".txt"


def list_samples(root: str | None = None) -> list[dict]:
    """Recursive scan for .wav files; display name = relative path sans
    extension (the reference uses "<set>/<speaker>/<clip>" display names)."""
    root = root or samples_root()
    out: list[dict] = []
    if not os.path.isdir(root):
        return out
    for dirpath, _dirs, files in os.walk(root):
        for fname in files:
            if not fname.lower().endswith(".wav"):
                continue
            full = os.path.join(dirpath, fname)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            out.append({
                "name": os.path.splitext(rel)[0],
                "path": rel,
                "has_text": os.path.exists(_transcript_path(full)),
            })
    out.sort(key=lambda s: s["name"])
    return out


def load_sample(rel_path: str, root: str | None = None) -> dict:
    """Return one sample as {audio_base64, prompt_text}.

    Raises ValueError on paths that escape the samples root (same guard as
    models_admin.delete_model) or that don't exist.
    """
    root = root or samples_root()
    root_real = os.path.realpath(root)
    full = os.path.realpath(os.path.join(root, rel_path))
    if full != root_real and not full.startswith(root_real + os.sep):
        raise ValueError("path escapes the samples root")
    if not os.path.isfile(full):
        raise ValueError(f"no such sample: {rel_path}")
    with open(full, "rb") as f:
        audio_b64 = base64.b64encode(f.read()).decode("ascii")
    prompt_text = ""
    txt = _transcript_path(full)
    if os.path.exists(txt):
        with open(txt, encoding="utf-8") as f:
            prompt_text = f.read().strip()
    return {"audio_base64": audio_b64, "prompt_text": prompt_text}
