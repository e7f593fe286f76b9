"""The port's preprocessing stages (preprocess/resample, vad, transcribe,
extract_tokens, merge), the saved-dataset pieces they need
(utils/hf_dataset.py) and the data route (/api/v1/data/run) against the JAX
package and the `datasets` library on the CPU.

- `concatenate_datasets` and the DatasetDict writer give `datasets`' rows and
  features; a job's log and corpus_stats.json beside a dataset are ignored.
- Each stage's `main` runs in both packages on the same input directory:
  stage 1's WAVs within one int16 step; stage 2's segment files equal, within
  one int16 step; stage 3's rows, dataset_info.json features and
  corpus_stats.json equal (native ASR, a sidecar transcript, loudness
  normalisation), and 2 workers give 1 worker's rows; stage 4's tokens
  exact, mels within 1e-3 absolute (log-mel, values down to -11.5) and
  embeddings within 1e-5 (values ~0.06), over a DatasetDict, with a row
  too short for a token dropped, and 2 processes give 1 process's rows
  bit for bit; stage 5's rows and features equal. `datasets.load_from_disk`
  reads every dataset the port writes as it reads JAX's.
- `build_data_command` equals JAX's for stages 1-5, up to the module prefix
  and the port's `--device`; the route answers 200 or 400, and a stage-5
  job runs to completed.

How the JAX stages run here: stage 1 as a subprocess (its process pool
forks, and a fork of a process that holds JAX deadlocks); stage 4 with
`datasets.Dataset.map` made sequential, since datasets 5's map forks a pool
even at num_proc 1. Stage 4 runs the committed extractor checkpoints, copied
without their `.json` sidecars: the JAX stage runs a checkpoint at the
default architecture whatever its sidecar says, and the port reads the
sidecar (so does it here, and finds none)."""

import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import datasets
import numpy as np
import pytest

from flowmirror_hydravox_tpu.preprocess import extract_tokens as jax_extract
from flowmirror_hydravox_tpu.preprocess import merge as jax_merge
from flowmirror_hydravox_tpu.preprocess import transcribe as jax_transcribe
from flowmirror_hydravox_tpu.preprocess import vad as jax_vad
from flowmirror_hydravox_tpu.runtime.training_manager import TrainingManager as JaxManager
from flowmirror_hydravox_tpu_torch import __main__ as launcher
from flowmirror_hydravox_tpu_torch.frontend.frontend import ASSET_DIR
from flowmirror_hydravox_tpu_torch.preprocess import (extract_tokens, merge, resample,
                                                      transcribe, vad)
from flowmirror_hydravox_tpu_torch.runtime.server import make_server
from flowmirror_hydravox_tpu_torch.runtime.training_manager import TrainingManager
from flowmirror_hydravox_tpu_torch.train.synth_speech import synth_utterance_with_segments
from flowmirror_hydravox_tpu_torch.utils import hf_dataset
from flowmirror_hydravox_tpu_torch.utils.wavio import decode_wav, encode_wav
from tests.torch_port_util import n  # noqa: F401  (caps torch at one thread)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEL_ATOL = 1e-3
EMB_ATOL = 1e-5
CPU = ["--device", "cpu"]


def _features(path):
    with open(os.path.join(path, "dataset_info.json")) as f:
        return json.load(f)["features"]


def _wavs(root):
    return {str(p.relative_to(root)): decode_wav(p.read_bytes())
            for p in sorted(root.rglob("*.wav"))}


def _corpus(root, n_clips=3, sr=16000, seconds=4.0):
    """Held-out synthetic clips (speakers 300+, utterances 30000+) in two
    sub-directories, the first with a sidecar transcript."""
    for i in range(n_clips):
        d = root / ("a" if i < 2 else "b")
        d.mkdir(parents=True, exist_ok=True)
        wav = synth_utterance_with_segments(300 + i, 30_000 + i, seconds, seed=1)[0]
        if sr != 16000:
            wav = np.interp(np.arange(int(seconds * sr)) * (16000 / sr), np.arange(len(wav)),
                            wav).astype(np.float32)
        (d / f"u{i}.wav").write_bytes(encode_wav(wav, sr))
    (root / "a" / "u0.txt").write_text("你好 世界  hello")


@pytest.fixture
def sequential_map(monkeypatch):
    """datasets' map in the calling process (see the module docstring)."""
    orig = datasets.Dataset.map
    monkeypatch.setattr(datasets.Dataset, "map",
                        lambda self, *a, num_proc=None, **kw: orig(self, *a, **kw))


def test_concatenate_and_dataset_dict_match_datasets(tmp_path):
    a = [{"text": "a", "ids": [1, 2], "x": 0.5}, {"text": "b", "ids": [3], "x": None}]
    b = [{"ids": [4, 5, 6], "text": "c", "x": 1.5}]
    c = [{"text": "d", "ids": [7]}]
    for rows, name in ((a, "a"), (b, "b"), (c, "c")):
        hf_dataset.save_to_disk(rows, str(tmp_path / name))
    for names in (("a", "b"), ("a", "c", "b")):
        got = hf_dataset.concatenate_datasets(
            [hf_dataset.load_from_disk(str(tmp_path / k)) for k in names])
        want = datasets.concatenate_datasets(
            [datasets.load_from_disk(str(tmp_path / k)) for k in names])
        assert list(got) == list(want) and got.column_names == want.column_names
        hf_dataset.save_to_disk(got, str(tmp_path / "cat"))
        back = datasets.load_from_disk(str(tmp_path / "cat"))
        assert list(back) == list(want) and back.features == want.features
    # a selection keeps its order through the chain
    got = hf_dataset.concatenate_datasets([hf_dataset.load_from_disk(str(tmp_path / "a"))
                                           .select([1, 0]), hf_dataset.load_from_disk(
                                               str(tmp_path / "b"))])
    assert [r["text"] for r in got] == ["b", "a", "c"]
    hf_dataset.save_to_disk([{"text": "e", "ids": [1.5], "x": 2.0}], str(tmp_path / "f"))
    with pytest.raises(ValueError, match="key ids"):
        datasets.concatenate_datasets([datasets.load_from_disk(str(tmp_path / k)) for k in "af"])
    with pytest.raises(ValueError, match="key ids"):
        hf_dataset.concatenate_datasets([hf_dataset.load_from_disk(str(tmp_path / k))
                                         for k in "af"])

    for split, rows in (("train", a), ("test", b)):
        hf_dataset.save_to_disk(rows, str(tmp_path / "dd" / split))
    hf_dataset.save_dataset_dict_json(str(tmp_path / "dd"), ["train", "test"])
    for side in ("data_stage3_0123abcd.log", "corpus_stats.json"):
        (tmp_path / "dd" / "train" / side).write_text("{}")
    want = datasets.load_from_disk(str(tmp_path / "dd"))
    got = hf_dataset.load_from_disk(str(tmp_path / "dd"))
    assert list(want) == list(got) == ["train", "test"]
    for split in want:
        assert list(want[split]) == list(got[split])
        assert got[split].features == _features(str(tmp_path / "dd" / split))


def test_stages_1_2_match_jax(tmp_path):
    raw, jax_dir, port_dir = tmp_path / "raw", tmp_path / "jax", tmp_path / "port"
    _corpus(raw)
    proc = subprocess.run(
        [sys.executable, "-m", "flowmirror_hydravox_tpu.preprocess.resample", "--input_dir",
         str(raw), "--output_dir", str(jax_dir / "s1"), "--num_workers", "1"],
        capture_output=True, text=True, timeout=240, cwd=ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-2000:]
    resample.main(["--input_dir", str(raw), "--output_dir", str(port_dir / "s1"),
                   "--num_workers", "1"] + CPU)
    want, got = _wavs(jax_dir / "s1"), _wavs(port_dir / "s1")
    assert list(got) == list(want) == ["a/u0.wav", "a/u1.wav", "b/u2.wav"]
    for k in want:
        assert got[k][1] == want[k][1] == 24000
        assert got[k][0].shape == want[k][0].shape
        assert np.abs(got[k][0] - want[k][0]).max() <= 1 / 32768 + 1e-9, k

    # stage 2 on the same input (JAX's stage-1 output), the native VAD
    jax_vad.main(["--input_dir", str(jax_dir / "s1"), "--output_dir", str(jax_dir / "s2"),
                  "--model", "native"])
    vad.main(["--input_dir", str(jax_dir / "s1"), "--output_dir", str(port_dir / "s2"),
              "--model", "native"] + CPU)
    want, got = _wavs(jax_dir / "s2"), _wavs(port_dir / "s2")
    assert list(got) == list(want) and len(want) >= 3
    for k in want:
        assert got[k][0].shape == want[k][0].shape, k
        assert np.abs(got[k][0] - want[k][0]).max() <= 1 / 32768 + 1e-9, k


def test_stage3_matches_jax(tmp_path):
    src = tmp_path / "in"
    _corpus(src, sr=24000)
    (src / "b" / "short.wav").write_bytes(encode_wav(np.zeros(800, np.float32), 16000))
    (src / "b" / "bad.wav").write_bytes(b"nope")
    args = ["--input_dir", str(src), "--asr_module", "native", "--no_filename_fallback",
            "--normalize_loudness", "--min_sec", "0.5"]
    jax_transcribe.main(args + ["--output_dir", str(tmp_path / "jax")])
    transcribe.main(args + ["--output_dir", str(tmp_path / "port")] + CPU)
    transcribe.main(args + ["--output_dir", str(tmp_path / "port2"), "--num_workers", "2"] + CPU)
    want = datasets.load_from_disk(str(tmp_path / "jax"))
    for out in ("port", "port2"):
        got = datasets.load_from_disk(str(tmp_path / out))
        assert len(got) == len(want) == 3 and got["text"] == want["text"]
        assert got["text"][0] == "你好世界 hello"  # the sidecar, cleaned
        for r_got, r_want in zip(got, want):
            assert r_got["audio"] == r_want["audio"]
        assert _features(str(tmp_path / out)) == _features(str(tmp_path / "jax"))
        assert (json.loads((tmp_path / out / "corpus_stats.json").read_text())
                == json.loads((tmp_path / "jax" / "corpus_stats.json").read_text()))
    ours = hf_dataset.load_from_disk(str(tmp_path / "port"))
    assert [r["text"] for r in ours] == want["text"]


def _stage3_dataset(path, sr=16000, seconds=2.0):
    """A DatasetDict as stage 3 writes one: train with two equal-length
    clips, test with one clip too short for a token, saved by `datasets`."""
    rows = [{"text": f"row {i}", "audio": {
        "array": synth_utterance_with_segments(310 + i, 30_100 + i, seconds, seed=1)[0],
        "sampling_rate": sr}} for i in range(2)]
    short = [{"text": "short", "audio": {"array": np.full(300, 0.1, np.float32),
                                         "sampling_rate": sr}}]
    datasets.DatasetDict({
        split: datasets.Dataset.from_dict({"text": [r["text"] for r in part],
                                           "audio": [r["audio"] for r in part]})
        for split, part in (("train", rows), ("test", short))}).save_to_disk(path)


def test_stage4_matches_jax(tmp_path, sequential_map):
    _stage3_dataset(str(tmp_path / "s3"))
    for name in ("tokenizer", "speaker"):  # the checkpoints without their sidecars
        shutil.copy(os.path.join(ASSET_DIR, f"{name}.npz"), tmp_path / f"{name}.npz")
    args = ["--input_dir", str(tmp_path / "s3"), "--tokenizer_ckpt",
            str(tmp_path / "tokenizer.npz"), "--speaker_ckpt", str(tmp_path / "speaker.npz")]
    jax_extract.main(args + ["--output_dir", str(tmp_path / "jax")])
    extract_tokens.main(args + ["--output_dir", str(tmp_path / "port")] + CPU)
    extract_tokens.main(args + ["--output_dir", str(tmp_path / "port2"), "--num_proc", "2"]
                        + CPU)
    want = datasets.load_from_disk(str(tmp_path / "jax"))
    got = datasets.load_from_disk(str(tmp_path / "port"))
    assert list(got) == list(want) == ["train", "test"]
    assert len(want["train"]) == 2 and len(want["test"]) == 0
    for split in want:
        assert _features(str(tmp_path / "port" / split)) == _features(str(tmp_path / "jax" / split))
        assert list(datasets.load_from_disk(str(tmp_path / "port2"))[split]) == list(got[split])
        for r_got, r_want in zip(got[split], want[split]):
            assert r_got["speech_token"] == r_want["speech_token"]
            assert r_got["speech_token_len"] == r_want["speech_token_len"] > 0
            assert r_got["mel_len"] == r_want["mel_len"] == 2 * r_want["speech_token_len"]
            np.testing.assert_allclose(r_got["mel"], r_want["mel"], rtol=0, atol=MEL_ATOL)
            np.testing.assert_allclose(r_got["embedding"], r_want["embedding"], rtol=0,
                                       atol=EMB_ATOL)
            assert (r_got["text"], r_got["audio"]) == (r_want["text"], r_want["audio"])


def test_stage5_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    for part in ("p0", "p1"):
        datasets.Dataset.from_dict({
            "text": [f"{part} {i}" for i in range(3)],
            "speech_token": [rng.integers(0, 6561, 4).tolist() for _ in range(3)],
            "speech_token_len": [4] * 3,
            "embedding": [rng.standard_normal(8).astype(np.float32) for _ in range(3)],
            "mel": [rng.standard_normal((8, 80)).astype(np.float32) for _ in range(3)],
            "mel_len": [8] * 3}).save_to_disk(str(tmp_path / part))
    inputs = f"{tmp_path / 'p1'},{tmp_path / 'p0'}"
    jax_merge.main(["--input_dir", inputs, "--output_dir", str(tmp_path / "jax")])
    merge.main(["--input_dir", inputs, "--output_dir", str(tmp_path / "port")])
    want = datasets.load_from_disk(str(tmp_path / "jax"))
    got = datasets.load_from_disk(str(tmp_path / "port"))
    assert list(got) == list(want) and len(want) == 6
    assert _features(str(tmp_path / "port")) == _features(str(tmp_path / "jax"))
    assert [r["text"] for r in hf_dataset.load_from_disk(str(tmp_path / "port"))] == want["text"]


def test_data_commands_match_jax():
    port, jax_mgr = TrainingManager(device="cpu", tiny=True), JaxManager()
    base = {"input_dir": "in", "output_dir": "out"}
    full = {**base, "sample_rate": 16000, "min_dur": 0.3, "max_dur": 8.0, "min_gap": 0.2,
            "vad_model": "native", "transcript_file": "t.tsv", "asr_module": "native",
            "num_workers": 2, "min_sec": 0.5, "normalize_loudness": True,
            "no_filename_fallback": True}
    for stage in ("1", "2", "3", "4", "5", 3):
        for req in (base, full):
            got = port.build_data_command({**req, "stage": stage})
            want = jax_mgr.build_data_command({**req, "stage": stage})
            assert got[2] == want[2].replace("flowmirror_hydravox_tpu.",
                                             "flowmirror_hydravox_tpu_torch.")
            tail = [] if str(stage) == "5" else ["--device", "cpu"]
            assert got[:2] + got[3:] == want[:2] + want[3:] + tail, (stage, req)
    assert TrainingManager(device="cuda").build_data_command(
        {**base, "stage": 4})[-2:] == ["--device", "cuda"]
    for bad in ({**base, "stage": "9"}, {"stage": "1", "output_dir": "out"}):
        assert port.start_data_stage(bad)["success"] is False
    with pytest.raises(ValueError, match="unknown stage 9"):
        port.build_data_command({**base, "stage": 9})


def _call(base, path, body):
    req = urllib.request.Request(base + path, json.dumps(body).encode(),
                                 {"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_data_route_runs_a_stage(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the stage, beside other workers
    for part in ("p0", "p1"):
        hf_dataset.save_to_disk([{"text": f"{part} {i}", "speech_token": [i, i + 1]}
                                 for i in range(2)], str(tmp_path / part))
    engine, frontend = launcher.build(launcher.parse_args(
        ["--tiny", "--device", "cpu", "--max-tokens", "16"]))
    manager = TrainingManager(device="cpu", tiny=True)
    server = make_server("127.0.0.1", 0, engine, frontend, training=manager)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    out = tmp_path / "merged"
    try:
        code, body = _call(base, "/api/v1/data/run", {"stage": "9", "input_dir": "i",
                                                      "output_dir": str(tmp_path / "x")})
        assert code == 400 and body["error"] == "unknown stage 9"
        assert _call(base, "/api/v1/data/run", {"stage": "1"})[0] == 400
        code, body = _call(base, "/api/v1/data/run", {
            "stage": "5", "input_dir": f"{tmp_path / 'p0'},{tmp_path / 'p1'}",
            "output_dir": str(out)})
        assert code == 200 and body["message"] == "stage started", body
        tid = body["data"]["training_id"]
        assert os.path.basename(body["data"]["log_path"]) == f"data_stage5_{tid}.log"
        deadline = time.time() + 120
        while manager.get_training_status(tid)["status"] == "running" and time.time() < deadline:
            time.sleep(0.2)
        status = manager.get_training_status(tid)
        assert status["status"] == "completed" and status["returncode"] == 0, \
            open(manager.trainings[tid]["log_path"]).read()
        assert status["model_type"] == "data_stage5"
        assert manager.active_id is None  # a data stage is not the running training
        # the job's log sits beside the dataset, which both readers read
        assert [r["text"] for r in hf_dataset.load_from_disk(str(out))] == \
            datasets.load_from_disk(str(out))["text"] == ["p0 0", "p0 1", "p1 0", "p1 1"]
    finally:
        manager.stop_all()
        server.shutdown()
        server.server_close()
