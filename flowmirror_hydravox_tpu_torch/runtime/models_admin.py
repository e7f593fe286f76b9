"""Model management: port of flowmirror_hydravox_tpu/runtime/models_admin.py
(reference user_interface/tabs/training_tab.py:826-1070: list / delete /
convert checkpoints).

Every path resolves under a models root (the TTS_MODEL_ROOT environment
variable, default "checkpoints") and is containment-checked, so the HTTP
routes never touch a file outside it: an escape such as `../x` raises
ValueError (the route's 400). A convert job runs tools/convert_ckpt.py as a
subprocess of the server's `TrainingManager`, in the same registry as the
trainings (pollable at /api/v1/training/status/<id>).

The port's train states are `step_<n>.pt` files (train/checkpoint.py
`save_train_state`), not orbax directories. `list_models` lists them with
the kind the JAX package gives a train state ("orbax"), not as "weights";
a `step_<n>` directory or one with orbax's `_CHECKPOINT_METADATA` is listed
so too, as in JAX.
"""

from __future__ import annotations

import os
import re
import shutil
import sys
import time
from typing import List

MODEL_EXTS = (".pt", ".npz", ".safetensors")
_TRAIN_STATE = re.compile(r"step_\d+\.pt")


def models_root() -> str:
    return os.environ.get("TTS_MODEL_ROOT", "checkpoints")


def _resolve(root: str, rel: str) -> str:
    path = os.path.realpath(os.path.join(root, rel))
    root_real = os.path.realpath(root)
    if not (path == root_real or path.startswith(root_real + os.sep)):
        raise ValueError(f"path escapes models root: {rel}")
    return path


def list_models(root: str | None = None) -> List[dict]:
    """Model files (.pt/.npz/.safetensors) and train states under the root,
    newest first."""
    root = root or models_root()
    out: List[dict] = []
    if not os.path.isdir(root):
        return out
    for dirpath, dirnames, filenames in os.walk(root):
        for d in list(dirnames):
            full = os.path.join(dirpath, d)
            if os.path.exists(os.path.join(full, "_CHECKPOINT_METADATA")) or d.startswith("step_"):
                out.append(_entry(root, full, kind="orbax"))
                dirnames.remove(d)
        for f in filenames:
            if f.endswith(MODEL_EXTS):
                kind = "orbax" if _TRAIN_STATE.fullmatch(f) else "weights"
                out.append(_entry(root, os.path.join(dirpath, f), kind=kind))
    out.sort(key=lambda e: -e["mtime"])
    return out


def _entry(root: str, path: str, kind: str) -> dict:
    if os.path.isdir(path):
        size = sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(path) for f in fs)
    else:
        size = os.path.getsize(path)
    return {
        "path": os.path.relpath(path, root),
        "kind": kind,
        "size_mb": round(size / 1e6, 2),
        "mtime": os.path.getmtime(path),
        "modified": time.strftime("%Y-%m-%d %H:%M", time.localtime(os.path.getmtime(path))),
    }


def delete_model(rel: str, root: str | None = None) -> dict:
    root = root or models_root()
    path = _resolve(root, rel)
    if not os.path.exists(path):
        return {"success": False, "error": f"not found: {rel}"}
    if os.path.isdir(path):
        shutil.rmtree(path)
    else:
        os.remove(path)
    return {"success": True, "deleted": rel}


def convert_model(req: dict, manager) -> dict:
    """Start a convert job on `manager` (a TrainingManager): {action:
    import|average|graft-mtp, model?, src | inputs, dst, tiny?}."""
    action = req.get("action", "import")
    if action not in ("import", "average", "graft-mtp"):
        return {"success": False, "error": f"unknown action {action}"}
    cmd = [sys.executable, "-m", "flowmirror_hydravox_tpu_torch.tools.convert_ckpt", action]
    if action in ("import", "average"):
        cmd += ["--model", req.get("model", "llm")]
    if action == "average":
        inputs = req.get("inputs") or []
        if not inputs:
            return {"success": False, "error": "inputs required"}
        cmd += ["--inputs", *inputs]
    else:
        if not req.get("src"):
            return {"success": False, "error": "src required"}
        cmd += ["--src", req["src"]]
    if not req.get("dst"):
        return {"success": False, "error": "dst required"}
    cmd += ["--dst", req["dst"]]
    if req.get("tiny"):
        cmd.append("--tiny")
    out_dir = os.path.dirname(req["dst"]) or "."
    os.makedirs(out_dir, exist_ok=True)
    return manager._spawn(cmd, out_dir, label=f"convert-{action}")
