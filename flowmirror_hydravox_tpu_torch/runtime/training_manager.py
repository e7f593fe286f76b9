"""Training process manager: port of
flowmirror_hydravox_tpu/runtime/training_manager.py (reference
server/training_manager.py:13-322).

Spawns a trainer as a subprocess in a process group of its own
(`python -m flowmirror_hydravox_tpu_torch.train.<train_llm|train_flow|
train_hift|train_dpo>`), with one log file per job, tracks its status,
tails its log incrementally, and stops it with SIGTERM, then SIGKILL after
a grace period. One training runs at a time (reference behaviour). The
preprocessing stages (`start_data_stage`, `python -m
flowmirror_hydravox_tpu_torch.preprocess.<resample|vad|transcribe|
extract_tokens|merge>`) are jobs of the same registry, labelled
`data_stage<N>`, and do not count as the running training.

The request schema and the trainer flags are JAX's (`build_command`). The
manager adds two flags of its own to every trainer: `--device <device>`,
the server's device, so a job runs on the card unless the server runs on
the CPU, and `--tiny` when the server runs the tiny config. A multi-device
flag in a request (`tensor_parallel`, `shard_optimizer`,
`pipeline_parallel`) still reaches the trainer, as in JAX; the port's
trainers refuse it with exit 2 (train/cli.py), so the job ends `failed`
with returncode 2.

The data stages take JAX's request schema and flags (`build_data_command`),
and stages 1-4 also `--device <device>`, so their models and resampling run
on the server's device; stage 5 runs on the host.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import threading
import time
import uuid
from typing import Dict, List, Optional

logger = logging.getLogger("hydravox.training_manager")

PACKAGE = "flowmirror_hydravox_tpu_torch"


class TrainingManager:
    """The server's job registry: trainings and convert jobs
    (runtime/models_admin.py), each a subprocess of `_spawn`."""

    _TRAIN_MODULES = {
        "llm": "train_llm",
        "flow": "train_flow",
        "hift": "train_hift",
        "dpo": "train_dpo",
    }

    def __init__(self, device: str = "cuda", tiny: bool = False):
        self.device, self.tiny = str(device), tiny
        self.lock = threading.Lock()
        self.trainings: Dict[str, dict] = {}
        self.active_id: Optional[str] = None

    def build_command(self, req: dict) -> List[str]:
        """Request fields -> trainer CLI, per model family (JAX
        training_manager.py:38-77; reference _build_training_command
        :78), then the port's `--device` and `--tiny`."""
        model_type = req.get("model_type", "llm")
        module = f"{PACKAGE}.train." + self._TRAIN_MODULES.get(model_type, "train_llm")
        cmd = [
            sys.executable, "-m", module,
            "--train_data", req["train_data"],
            "--output_dir", req.get("output_dir", "checkpoints/training"),
            "--batch_size", str(req.get("batch_size", 4)),
            "--learning_rate", str(req.get("learning_rate", 1e-4)),
            "--logging_steps", str(req.get("logging_steps", 50)),
            "--save_steps", str(req.get("save_steps", 2000)),
        ]
        if req.get("model_checkpoint") and model_type != "hift":
            cmd += ["--model_ckpt", req["model_checkpoint"]]
        if req.get("epochs") and model_type != "hift":
            cmd += ["--epochs", str(req["epochs"])]
        if req.get("max_steps"):
            cmd += ["--max_steps", str(req["max_steps"])]
        if req.get("warmup_steps") and model_type != "hift":
            cmd += ["--warmup_steps", str(req["warmup_steps"])]
        if req.get("shard_optimizer"):
            cmd.append("--shard_optimizer")
        if req.get("tensor_parallel") and model_type in ("llm", "flow"):
            cmd += ["--tensor_parallel", str(req["tensor_parallel"])]
        if req.get("pipeline_parallel") and model_type == "llm":
            cmd += ["--pipeline_parallel", str(req["pipeline_parallel"])]
            if req.get("pp_microbatches"):
                cmd += ["--pp_microbatches", str(req["pp_microbatches"])]
        if req.get("phoneme_aug") and model_type == "llm":
            cmd.append("--phoneme_aug")
        if model_type == "llm":
            if req.get("tokenizer_path"):
                cmd += ["--tokenizer_path", req["tokenizer_path"]]
            if req.get("auto_val_split"):
                cmd += ["--auto_val_split", "--val_split_ratio",
                        str(req.get("val_split_ratio", 0.05))]
        cmd += ["--device", self.device]
        if self.tiny:
            cmd.append("--tiny")
        return cmd

    def build_data_command(self, req: dict) -> List[str]:
        """A data-pipeline stage's CLI (JAX training_manager.py:79-127; the
        reference data_tab.py one-click pipeline): stage 1 resample, 2 vad,
        3 transcribe, 4 extract, 5 merge. Raises KeyError without input_dir
        or output_dir and ValueError on another stage."""
        stage = str(req.get("stage"))
        base = [sys.executable, "-m"]
        device = ["--device", self.device]
        if stage == "1":
            return base + [f"{PACKAGE}.preprocess.resample",
                           "--input_dir", req["input_dir"], "--output_dir", req["output_dir"],
                           "--sample_rate", str(req.get("sample_rate", 24000))] + device
        if stage == "2":
            cmd = base + [f"{PACKAGE}.preprocess.vad",
                          "--input_dir", req["input_dir"], "--output_dir", req["output_dir"]]
            for key, flag in (("min_dur", "--min_dur"), ("max_dur", "--max_dur"),
                              ("min_gap", "--min_gap"), ("vad_model", "--model")):
                if req.get(key) is not None:
                    cmd += [flag, str(req[key])]
            return cmd + device
        if stage == "3":
            cmd = base + [f"{PACKAGE}.preprocess.transcribe",
                          "--input_dir", req["input_dir"], "--output_dir", req["output_dir"]]
            if req.get("transcript_file"):
                cmd += ["--transcript_file", req["transcript_file"]]
            if req.get("asr_module"):
                cmd += ["--asr_module", req["asr_module"]]
            for key, flag in (("num_workers", "--num_workers"), ("min_sec", "--min_sec")):
                if req.get(key) is not None:
                    cmd += [flag, str(req[key])]
            if req.get("normalize_loudness"):
                cmd.append("--normalize_loudness")
            if req.get("no_filename_fallback"):
                cmd.append("--no_filename_fallback")
            return cmd + device
        if stage == "4":
            return base + [f"{PACKAGE}.preprocess.extract_tokens",
                           "--input_dir", req["input_dir"],
                           "--output_dir", req["output_dir"]] + device
        if stage == "5":
            return base + [f"{PACKAGE}.preprocess.merge",
                           "--input_dir", req["input_dir"], "--output_dir", req["output_dir"]]
        raise ValueError(f"unknown stage {stage}")

    def start_data_stage(self, req: dict) -> dict:
        """A preprocessing stage as a job of the registry (JAX :129-136), its
        log `<output_dir>/data_stage<N>_<id>.log`; a request without its
        directories or of another stage fails."""
        try:
            cmd = self.build_data_command(req)
        except (KeyError, ValueError) as e:
            return {"success": False, "error": str(e)}
        return self._spawn(cmd, req.get("output_dir", "data_out"), f"data_stage{req.get('stage')}")

    def _spawn(self, cmd: List[str], output_dir: str, label: str) -> dict:
        """Start `cmd` in a new session (its own process group), its output
        to `<output_dir>/<label>_<id>.log`, with the package importable
        whatever the server's working directory (JAX :129-161)."""
        with self.lock:
            tid = str(uuid.uuid4())[:8]
            os.makedirs(output_dir, exist_ok=True)
            log_path = os.path.join(output_dir, f"{label}_{tid}.log")
            log_f = open(log_path, "w")
            pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            env = dict(os.environ)
            env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
            try:
                proc = subprocess.Popen(cmd, stdout=log_f, stderr=subprocess.STDOUT, env=env,
                                        start_new_session=True)
            except Exception as e:
                log_f.close()
                return {"success": False, "error": str(e)}
            self.trainings[tid] = {
                "id": tid,
                "status": "running",
                "command": cmd,
                "pid": proc.pid,
                "process": proc,
                "log_path": log_path,
                "log_file": log_f,
                "log_offset": 0,
                "model_type": label,
                "output_dir": output_dir,
                "start_time": time.time(),
            }
            logger.info("started %s %s: %s", label, tid, " ".join(cmd))
            return {"success": True, "training_id": tid, "log_path": log_path}

    def start_training(self, req: dict) -> dict:
        """One training at a time (JAX :163-175): a start while one runs, or
        without `train_data`, fails."""
        with self.lock:
            if self.active_id and self.trainings[self.active_id]["status"] == "running":
                return {"success": False, "error": "a training is already running"}
        try:
            cmd = self.build_command(req)
        except KeyError as e:
            return {"success": False, "error": f"missing field {e}"}
        result = self._spawn(cmd, req.get("output_dir", "checkpoints/training"),
                             req.get("model_type", "llm"))
        if result.get("success"):
            self.active_id = result["training_id"]
        return result

    def stop_training(self, tid: str, grace_s: float = 10.0) -> dict:
        """SIGTERM the job's process group, SIGKILL it after `grace_s`
        (JAX :177-201)."""
        with self.lock:
            entry = self.trainings.get(tid)
            if entry is None:
                return {"success": False, "error": f"unknown training {tid}"}
            proc = entry["process"]
        if proc.poll() is None:
            for sig in (signal.SIGTERM, signal.SIGKILL):
                try:
                    os.killpg(proc.pid, sig)
                except ProcessLookupError:
                    break
                deadline = time.time() + grace_s
                while proc.poll() is None and time.time() < deadline:
                    time.sleep(0.2)
                if proc.poll() is not None:
                    break
        with self.lock:
            entry["status"] = "stopped"
            entry["log_file"].close()
        return {"success": True}

    def stop_all(self, grace_s: float = 10.0):
        """Stop every job still running (the server's shutdown)."""
        with self.lock:
            running = [tid for tid, e in self.trainings.items() if e["process"].poll() is None]
        for tid in running:
            self.stop_training(tid, grace_s)

    def _refresh(self, entry: dict):
        proc = entry["process"]
        if entry["status"] == "running" and proc.poll() is not None:
            entry["status"] = "completed" if proc.returncode == 0 else "failed"
            entry["returncode"] = proc.returncode
            entry["log_file"].close()

    def get_training_status(self, tid: str, tail_bytes: int = 65536) -> dict:
        """Status and the log written since the last call (JAX :212-236)."""
        with self.lock:
            entry = self.trainings.get(tid)
            if entry is None:
                return {"success": False, "error": f"unknown training {tid}"}
            self._refresh(entry)
            new_log = ""
            try:
                with open(entry["log_path"]) as f:
                    f.seek(entry["log_offset"])
                    new_log = f.read(tail_bytes)
                    entry["log_offset"] = f.tell()
            except OSError:
                pass
            return {
                "success": True,
                "training_id": tid,
                "status": entry["status"],
                "model_type": entry["model_type"],
                "output_dir": entry["output_dir"],
                "elapsed_s": time.time() - entry["start_time"],
                "new_log": new_log,
                "returncode": entry.get("returncode"),
            }

    def list_trainings(self) -> List[dict]:
        with self.lock:
            for e in self.trainings.values():
                self._refresh(e)
            return [{k: e[k] for k in ("id", "status", "model_type", "output_dir")}
                    for e in self.trainings.values()]
