"""The port's training and model-admin routes (runtime/training_manager.py,
training_plots.py, models_admin.py, tools/convert_ckpt.py) against the JAX
package's, on the CPU:

- `build_command` for every family equals JAX's `TrainingManager().
  build_command` on the same requests, up to the module prefix and the
  port's own `--device` / `--tiny`;
- over the port's HTTP server (tiny engine; the manager on `cpu` + tiny), a
  route-started `train_llm` over a dataset the port's writer made: a second
  start while it runs is 400, its status goes running -> completed with rc
  0 and a log tail that never repeats itself, it is listed, its plot is a
  990 x 550 PNG whose points are the JAX parser's; a job stopped at step 2
  ends `stopped` with its process group gone; a `tensor_parallel` job ends
  `failed` with rc 2 (the trainer refuses it), and its plot, once its log
  is gone, is 500; unknown ids are 404, and
  /api/v1/data/run without its directories is 400 (a stage runs in
  tests/test_torch_preprocess_data.py); then
  /api/v1/models/{list,convert,delete} under TTS_MODEL_ROOT. Three trainer
  subprocesses, one of which exits at its argument parsing;
- `models_admin` list / delete / the containment guard equal JAX's on the
  same tree (the port's `step_<n>.pt` train states listed as train states);
- `convert_ckpt`: `average` equals JAX's bit for bit on the same npz inputs
  (f32); `import` from a `.pt` and from a `.safetensors` equals JAX's;
  `graft-mtp` keeps every non-MTP leaf bit for bit and gives fresh heads of
  JAX's shapes and dtypes.
"""

import io
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.runtime import models_admin as jax_admin
from flowmirror_hydravox_tpu.runtime.training_manager import TrainingManager as JaxManager
from flowmirror_hydravox_tpu.runtime.training_plots import parse_training_logs as jax_parse
from flowmirror_hydravox_tpu.tools import convert_ckpt as jax_convert
from flowmirror_hydravox_tpu.train import checkpoint as jax_ckpt
from flowmirror_hydravox_tpu_torch import __main__ as launcher
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.convert import torch_import
from flowmirror_hydravox_tpu_torch.params import flatten_params, from_numpy_tree
from flowmirror_hydravox_tpu_torch.runtime import models_admin
from flowmirror_hydravox_tpu_torch.runtime.server import make_server
from flowmirror_hydravox_tpu_torch.runtime.training_manager import TrainingManager
from flowmirror_hydravox_tpu_torch.runtime.training_plots import parse_training_logs
from flowmirror_hydravox_tpu_torch.tools import convert_ckpt
from flowmirror_hydravox_tpu_torch.utils import hf_dataset
from tests.torch_port_util import seeded_tiny_trees

CFG = tiny_config()
JOB_LIMIT_S = 240  # a tiny trainer's wall time on a loaded host stays far below


def test_build_command_matches_jax():
    port, jax_mgr = TrainingManager(device="cpu", tiny=True), JaxManager()
    base = {"train_data": "ds", "output_dir": "out"}
    full = {**base, "model_checkpoint": "w.npz", "epochs": 3, "max_steps": 9,
            "warmup_steps": 2, "batch_size": 6, "learning_rate": 3e-4, "logging_steps": 1,
            "save_steps": 5, "shard_optimizer": True, "tensor_parallel": 2,
            "pipeline_parallel": 2, "pp_microbatches": 4, "phoneme_aug": True,
            "tokenizer_path": "tok", "auto_val_split": True, "val_split_ratio": 0.1}
    for family in ("llm", "flow", "hift", "dpo", None):
        for req in (base, full, {**full, "pp_microbatches": 0, "auto_val_split": False}):
            req = dict(req) if family is None else {**req, "model_type": family}
            got, want = port.build_command(req), jax_mgr.build_command(req)
            assert got[-3:] == ["--device", "cpu", "--tiny"]
            assert got[2] == want[2].replace("flowmirror_hydravox_tpu.",
                                             "flowmirror_hydravox_tpu_torch.")
            assert got[:2] + got[3:-3] == want[:2] + want[3:], (family, req)
    assert TrainingManager(device="cuda").build_command(base)[-2:] == ["--device", "cuda"]
    with pytest.raises(KeyError):
        port.build_command({"output_dir": "out"})


def _call(base, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(base + path, data, {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def _json(base, path, body=None):
    code, _, raw = _call(base, path, body)
    return code, json.loads(raw)


def _poll(base, tid, until, chunks=None):
    """Status polls until `until(status)`, collecting each new log tail."""
    deadline = time.time() + JOB_LIMIT_S
    while time.time() < deadline:
        code, body = _json(base, f"/api/v1/training/status/{tid}")
        assert code == 200, body
        data = body["data"]
        if chunks is not None:
            chunks.append(data["new_log"])
        if until(data):
            return data
        time.sleep(0.3)
    raise AssertionError(f"job {tid} did not reach the state in {JOB_LIMIT_S} s")


def _llm_rows(n_rows=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"text": f"Sample {i}: the routes train on {i * 7} words.",
             "speech_token": rng.integers(0, 50, int(rng.integers(8, 24)))}
            for i in range(n_rows)]


def test_training_and_model_routes(tmp_path, monkeypatch):
    import matplotlib.image

    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the trainers, beside other workers
    root = tmp_path / "models"
    monkeypatch.setenv("TTS_MODEL_ROOT", str(root))
    hf_dataset.save_to_disk(_llm_rows(), str(tmp_path / "ds"))
    engine, frontend = launcher.build(launcher.parse_args(
        ["--tiny", "--device", "cpu", "--max-tokens", "16"]))
    manager = TrainingManager(device="cpu", tiny=True)
    server = make_server("127.0.0.1", 0, engine, frontend, training=manager)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    req = {"model_type": "llm", "train_data": str(tmp_path / "ds"),
           "output_dir": str(root / "run"), "batch_size": 4, "max_steps": 4,
           "logging_steps": 1, "save_steps": 100, "warmup_steps": 1, "learning_rate": 1e-3}
    try:
        assert _json(base, "/api/v1/training/start", {"output_dir": "x"})[0] == 400
        code, body = _json(base, "/api/v1/training/start", req)
        assert code == 200 and body["message"] == "training started", body
        tid = body["data"]["training_id"]
        code, body = _json(base, "/api/v1/training/start", req)
        assert code == 400 and body["error"] == "a training is already running"
        code, body = _json(base, "/api/v1/training/list")
        assert code == 200 and body["data"]["trainings"][0]["id"] == tid
        chunks = []
        done = _poll(base, tid, lambda d: d["status"] != "running", chunks)
        log_path = manager.trainings[tid]["log_path"]
        log = open(log_path).read()
        assert done["status"] == "completed" and done["returncode"] == 0, log
        assert "".join(chunks) == log and sum(bool(c) for c in chunks) >= 1
        assert "training on device cpu" in log
        assert _json(base, f"/api/v1/training/status/{tid}")[1]["data"]["new_log"] == ""
        assert _json(base, "/api/v1/training/list")[1]["data"]["trainings"] == [
            {"id": tid, "status": "completed", "model_type": "llm",
             "output_dir": str(root / "run")}]
        code, ctype, png = _call(base, f"/api/v1/training/plot/{tid}")
        assert code == 200 and ctype == "image/png" and png[:8] == b"\x89PNG\r\n\x1a\n"
        assert matplotlib.image.imread(io.BytesIO(png)).shape[:2] == (550, 990)
        points = parse_training_logs(log)
        assert points == jax_parse(log) and points["steps"] == [1, 2, 3, 4]
        assert all(np.isfinite(points["losses"])) and len(points["accs"]) == 4
        hift_line = "INFO:hydravox.train_hift:step 4 gen 35.5 (adv 8.2 fm 4.3 mel 23.0) disc 8.2"
        assert parse_training_logs(hift_line) == jax_parse(hift_line)  # no loss field:
        assert parse_training_logs(hift_line)["steps"] == []  # an empty plot in both

        # a long job, stopped once its log shows step 2
        code, body = _json(base, "/api/v1/training/start",
                           {**req, "max_steps": 100000, "output_dir": str(tmp_path / "long")})
        assert code == 200, body
        tid_long = body["data"]["training_id"]
        pid = manager.trainings[tid_long]["pid"]
        seen = []
        _poll(base, tid_long, lambda d: "step 2 loss" in "".join(seen), seen)
        code, body = _json(base, f"/api/v1/training/stop/{tid_long}", {})
        assert code == 200 and body["success"], body
        assert _json(base, f"/api/v1/training/status/{tid_long}")[1]["data"]["status"] == "stopped"
        with pytest.raises(ProcessLookupError):
            os.killpg(pid, 0)

        # a multi-device flag reaches the trainer, which refuses it
        code, body = _json(base, "/api/v1/training/start",
                           {**req, "tensor_parallel": 2, "output_dir": str(tmp_path / "tp")})
        assert code == 200, body
        tid_tp = body["data"]["training_id"]
        failed = _poll(base, tid_tp, lambda d: d["status"] != "running")
        assert failed["status"] == "failed" and failed["returncode"] == 2
        assert "--tensor_parallel" in open(manager.trainings[tid_tp]["log_path"]).read()
        os.remove(manager.trainings[tid_tp]["log_path"])  # nothing left to plot
        code, body = _json(base, f"/api/v1/training/plot/{tid_tp}")
        assert code == 500 and body["message"] == "plot failed"

        for path, method_body in (("/api/v1/training/status/nope", None),
                                  ("/api/v1/training/plot/nope", None),
                                  ("/api/v1/training/stop/nope", {})):
            assert _call(base, path, method_body)[0] == 404, path
        assert _call(base, "/api/v1/data/run", {"stage": "1"})[0] == 400  # no directories

        # the model routes under TTS_MODEL_ROOT
        code, body = _json(base, "/api/v1/models/list")
        assert code == 200 and body["data"]["root"] == str(root)
        listed = {m["path"]: m["kind"] for m in body["data"]["models"]}
        assert listed == {os.path.join("run", "step_4.pt"): "orbax"}
        flat = flatten_params(seeded_tiny_trees()[0])
        a, b = str(root / "a.npz"), str(root / "b.npz")
        np.savez(a, **flat)
        np.savez(b, **{k: v * 0.5 + 0.25 for k, v in flat.items()})
        assert _json(base, "/api/v1/models/convert", {"action": "average"})[0] == 400
        code, body = _json(base, "/api/v1/models/convert",
                           {"action": "average", "model": "llm", "inputs": [a, b],
                            "dst": str(root / "avg" / "avg.npz"), "tiny": True})
        assert code == 200 and body["message"] == "convert started", body
        job = _poll(base, body["data"]["training_id"], lambda d: d["status"] != "running")
        assert job["status"] == "completed" and job["model_type"] == "convert-average", job
        with np.load(root / "avg" / "avg.npz") as f, np.load(a) as fa, np.load(b) as fb:
            assert set(f.files) == set(fa.files)
            for k in f.files:
                np.testing.assert_array_equal(f[k], (fa[k] + fb[k]) / np.float32(2), err_msg=k)
        assert _json(base, "/api/v1/models/delete", {})[0] == 400
        code, body = _json(base, "/api/v1/models/delete", {"path": "../x"})
        assert code == 400 and body["message"] == "bad path"
        assert _json(base, "/api/v1/models/delete", {"path": "missing.npz"})[0] == 404
        code, body = _json(base, "/api/v1/models/delete", {"path": "a.npz"})
        assert code == 200 and body["data"] == {"success": True, "deleted": "a.npz"}
        assert not os.path.exists(a)
    finally:
        manager.stop_all(grace_s=5)
        server.shutdown()
        server.server_close()
        server.RequestHandlerClass.service.shutdown()


def _model_tree(root):
    """A models root with every kind of entry, each with its own mtime."""
    files = ["a.npz", "sub/b.pt", "sub/deep/c.safetensors", "notes.txt",
             "orbax_run/step_5/x.bin", "meta_dir/_CHECKPOINT_METADATA", "meta_dir/d"]
    for i, rel in enumerate(files):
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(b"\0" * (1000 * (i + 1)))
        os.utime(p, (1_700_000_000 + i * 60, 1_700_000_000 + i * 60))
    for i, d in enumerate(("orbax_run/step_5", "meta_dir")):
        os.utime(root / d, (1_700_000_500 + i, 1_700_000_500 + i))


def test_models_admin_matches_jax(tmp_path):
    for name in ("port", "jax"):
        _model_tree(tmp_path / name)
    got = models_admin.list_models(str(tmp_path / "port"))
    want = jax_admin.list_models(str(tmp_path / "jax"))
    assert got == want and [m["path"] for m in got][0] == "meta_dir"
    for rel in ("sub/b.pt", "orbax_run/step_5", "missing.npz"):
        assert models_admin.delete_model(rel, str(tmp_path / "port")) == \
            jax_admin.delete_model(rel, str(tmp_path / "jax"))
    assert models_admin.list_models(str(tmp_path / "port")) == \
        jax_admin.list_models(str(tmp_path / "jax"))
    for rel in ("../x", "sub/../../x", "/etc"):
        for mod, name in ((models_admin, "port"), (jax_admin, "jax")):
            with pytest.raises(ValueError, match="escapes"):
                mod.delete_model(rel, str(tmp_path / name))
    # the port's train states: step_<n>.pt files, listed as train states
    (tmp_path / "port" / "run").mkdir()
    (tmp_path / "port" / "run" / "step_12.pt").write_bytes(b"\0")
    kinds = {m["path"]: m["kind"] for m in models_admin.list_models(str(tmp_path / "port"))}
    assert kinds[os.path.join("run", "step_12.pt")] == "orbax" and kinds["a.npz"] == "weights"
    assert models_admin.list_models(str(tmp_path / "none")) == []


def _npz(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _same_npz(got, want):
    got, want = _npz(got), _npz(want)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_convert_average_matches_jax(tmp_path):
    """The port's CLI against JAX's `cmd_average` body (`average_checkpoints`
    then `save_params_npz`) over an f32 template of the JAX tree's structure:
    the JAX CLI's own template, an eager JAX init, only adds seconds."""
    tree = seeded_tiny_trees()[0]
    flat = flatten_params(tree)
    inputs = []
    for i, scale in enumerate((1.0, -0.5, 0.3)):
        inputs.append(str(tmp_path / f"in{i}.npz"))
        np.savez(inputs[-1], **{k: (v * scale + i).astype(np.float32) for k, v in flat.items()})
    convert_ckpt.main(["average", "--model", "llm", "--inputs", *inputs,
                       "--dst", str(tmp_path / "port.npz"), "--tiny"])
    jax_ckpt.save_params_npz(str(tmp_path / "jax.npz"),
                             jax_ckpt.average_checkpoints(inputs, tree))
    _same_npz(str(tmp_path / "port.npz"), str(tmp_path / "jax.npz"))


@pytest.mark.parametrize("fmt", ["pt", "safetensors"])
def test_convert_import_matches_jax(tmp_path, fmt):
    """The reference llm.pt layout, keys behind the HF-Trainer `module.`
    prefix, as .pt or .safetensors (f32; a bf16 .safetensors is read as
    the `safetensors` package reads it)."""
    import safetensors.torch

    sd = torch_import.reference_state_dict("llm", from_numpy_tree(seeded_tiny_trees()[0], "cpu"),
                                           CFG)
    sd = {f"module.{k}": v.to(torch.float32).contiguous() for k, v in sd.items()}
    src = str(tmp_path / f"llm.{fmt}")
    if fmt == "pt":
        torch.save({**sd, "epoch": torch.tensor(3)}, src)
    else:
        safetensors.torch.save_file(sd, src)
        bf16 = str(tmp_path / "bf16.safetensors")
        safetensors.torch.save_file({k: v.to(torch.bfloat16) for k, v in
                                     list(sd.items())[:4]}, bf16)
        want = safetensors.torch.load_file(bf16)
        got = convert_ckpt.load_safetensors(bf16)
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v.to(torch.float32).numpy(), err_msg=k)
    for mod, out in ((convert_ckpt, "port.npz"), (jax_convert, "jax.npz")):
        mod.main(["import", "--model", "llm", "--src", src, "--dst", str(tmp_path / out),
                  "--tiny"])
    _same_npz(str(tmp_path / "port.npz"), str(tmp_path / "jax.npz"))


def test_convert_graft_mtp_keeps_the_rest(tmp_path):
    src = str(tmp_path / "single.npz")
    np.savez(src, **flatten_params(seeded_tiny_trees()[0]))
    for mod, out in ((convert_ckpt, "port.npz"), (jax_convert, "jax.npz")):
        mod.main(["graft-mtp", "--src", src, "--dst", str(tmp_path / out), "--tiny"])
    got, want, before = (_npz(str(tmp_path / p)) for p in ("port.npz", "jax.npz", "single.npz"))
    assert got.keys() == want.keys() == before.keys()
    heads = [k for k in got if k.startswith("mtp_block.")]
    assert heads
    for k in got:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        if k in heads:
            continue
        np.testing.assert_array_equal(got[k], before[k], err_msg=k)
    moved = [k for k in heads if not np.array_equal(got[k], before[k])]
    assert moved, "graft-mtp kept the old heads"
    for k in heads:  # drawn at bf16, as JAX's graft draws them
        as_bf16 = torch.from_numpy(got[k]).to(torch.bfloat16).to(torch.float32).numpy()
        np.testing.assert_array_equal(got[k], as_bf16, err_msg=k)
