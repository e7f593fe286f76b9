"""The port's HiFT GAN trainer (train/train_hift.py) and the GAN point of
tools/bench_train.py (tiny config, CPU):

- `featurize` and `batches` give the JAX trainer's batches (its featurize
  closure, train_hift.py:147-203, written out below over the JAX
  `resample_linear` and `mel_spectrogram`): rows with precomputed features
  (longer and shorter than the segment, with and without pitch) and rows
  with audio at 16 and 24 kHz, over three steps that cross an epoch; the
  crops and the epoch order exactly, the waveform within 1e-6 and the mel
  within 1e-5 (the audio functions' own tolerances, tests/test_torch_audio.py);
- `train_hift.main` on a tiny saved dataset (`--tiny --device cpu`,
  `--split_step`, `--grad_accum 2`) for 2 steps logs the JAX trainer's line,
  and its `hift_final.npz` loads in the JAX `load_params_npz` into the JAX
  HiFT's template, leaf for leaf, each leaf trained away from its init;
- the multi-device flags exit 2 naming the slice that ports them, and so
  does a `--grad_accum` that does not divide the batch;
- `bench_train --which gan --tiny --device cpu` prints its line and no
  device metric.
"""

import functools
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flowmirror_hydravox_tpu.config import tiny_config as jax_tiny_config
from flowmirror_hydravox_tpu.models import hift as jhift
from flowmirror_hydravox_tpu.train import checkpoint as jckpt
from flowmirror_hydravox_tpu.utils import audio as jaudio
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.params import flatten_params, init_hift_params
from flowmirror_hydravox_tpu_torch.tools import bench_train
from flowmirror_hydravox_tpu_torch.train import train_hift
from tests.torch_port_util import n

CFG = tiny_config()
UP = CFG.hift.upsample_scale
SEG = 8


@functools.lru_cache(maxsize=None)
def _jit(name, **static):
    return jax.jit(functools.partial(getattr(jaudio, name), **static))


def jax_featurize(row, seg_rng):
    """The JAX trainer's featurize closure (train_hift.py:147-179)."""
    m = jax_tiny_config().mel
    if "speech_feat" in row and row.get("speech_feat") is not None:
        mel = np.asarray(row["speech_feat"], np.float32)
        wav = np.asarray(row["speech"], np.float32)
    else:
        audio = row["audio"]
        wav = np.asarray(_jit("resample_linear", orig_sr=audio["sampling_rate"],
                              target_sr=m.sample_rate)(
            jnp.asarray(np.asarray(audio["array"], np.float32))[None]))[0]
        mel = np.asarray(_jit("mel_spectrogram", n_fft=m.n_fft, num_mels=m.num_mels,
                              sampling_rate=m.sample_rate, hop_size=m.hop_size,
                              win_size=m.win_size, fmin=m.fmin, fmax=m.fmax)(
            jnp.asarray(wav)[None]))[0].T
    tm = min(mel.shape[0], len(wav) // UP)
    if tm <= SEG:
        start = 0
        mel_seg = np.pad(mel[:tm], ((0, SEG - tm), (0, 0)))
        wav_seg = np.pad(wav[: tm * UP], (0, (SEG - tm) * UP))
    else:
        start = int(seg_rng.integers(0, tm - SEG))
        mel_seg = mel[start: start + SEG]
        wav_seg = wav[start * UP: (start + SEG) * UP]
    pitch = np.asarray(row.get("pitch_feat", np.zeros(mel.shape[0], np.float32)))
    pitch_seg = pitch[start: start + SEG]
    if len(pitch_seg) < SEG:
        pitch_seg = np.pad(pitch_seg, (0, SEG - len(pitch_seg)))
    return mel_seg, wav_seg, pitch_seg


def jax_batches(rows, batch_size, seed, n_steps):
    """The JAX trainer's loop order (train_hift.py:181-190), n_steps batches."""
    seg_rng = np.random.default_rng(seed)
    order = np.arange(len(rows))
    out = []
    while len(out) < n_steps:
        np.random.default_rng(seed + len(out)).shuffle(order)
        for start in range(0, len(order) - batch_size + 1, batch_size):
            picked = [rows[int(i)] for i in order[start: start + batch_size]]
            mels, wavs, pitches = zip(*[jax_featurize(r, seg_rng) for r in picked])
            out.append({"speech_feat": np.stack(mels), "speech": np.stack(wavs),
                        "pitch_feat": np.stack(pitches)})
            if len(out) == n_steps:
                break
    return out


def _rows(seed):
    rng = np.random.default_rng(seed)
    rows = []
    for frames, pitch in ((20, True), (5, False), (13, True)):
        row = {"speech": (rng.standard_normal(frames * UP + 37) * 0.1).astype(np.float32),
               "speech_feat": rng.standard_normal((frames, 80)).astype(np.float32)}
        if pitch:
            row["pitch_feat"] = (np.abs(rng.standard_normal(frames)) * 100).astype(np.float32)
        rows.append(row)
    for sr, seconds in ((16000, 0.5), (24000, 0.11), (16000, 0.31)):
        rows.append({"audio": {"array": (rng.standard_normal(int(sr * seconds)) * 0.1).astype(
            np.float32), "sampling_rate": sr}})
    return rows


def test_featurize_and_batches_match_jax():
    rows = _rows(0)
    want = jax_batches(rows, 4, 3, 3)
    stream = train_hift.batches(rows, 4, SEG, 3, UP, CFG.mel)
    for i, w in enumerate(want):
        got = next(stream)
        assert {k: v.shape for k, v in got.items()} == {
            "speech_feat": (4, SEG, 80), "speech": (4, SEG * UP), "pitch_feat": (4, SEG)}, i
        np.testing.assert_array_equal(got["pitch_feat"], w["pitch_feat"], err_msg=f"batch {i}")
        np.testing.assert_allclose(got["speech"], w["speech"], rtol=0, atol=1e-6,
                                   err_msg=f"batch {i}")
        np.testing.assert_allclose(got["speech_feat"], w["speech_feat"], rtol=0, atol=1e-5,
                                   err_msg=f"batch {i}")
    with pytest.raises(ValueError, match="no batch"):
        next(train_hift.batches(rows[:3], 4, SEG, 3, UP, CFG.mel))


def test_train_hift_main_writes_an_npz_that_jax_loads(tmp_path, caplog):
    import datasets

    rng = np.random.default_rng(1)
    datasets.Dataset.from_list([
        {"audio": {"array": (rng.standard_normal(int(rng.integers(2000, 6000))) * 0.1).tolist(),
                   "sampling_rate": 16000}} for _ in range(5)]).save_to_disk(str(tmp_path / "ds"))
    out = tmp_path / "out"
    with caplog.at_level(logging.INFO, logger="hydravox.train_hift"):
        res = train_hift.main(["--train_data", str(tmp_path / "ds"), "--output_dir", str(out),
                               "--tiny", "--device", "cpu", "--batch_size", "2",
                               "--segment_frames", str(SEG), "--max_steps", "2",
                               "--logging_steps", "1", "--save_steps", "2", "--split_step",
                               "--grad_accum", "2"])
    assert res["step"] == 2
    assert set(res["metrics"]) == {"gen_loss", "gen_grad_norm", "adv", "fm", "mel", "tpr", "f0",
                                   "disc_loss", "disc_grad_norm"}
    assert all(np.isfinite(v) for v in res["metrics"].values()), res
    lines = [r.getMessage() for r in caplog.records if r.name == "hydravox.train_hift"]
    line = re.compile(r"step (\d+) gen [-\d.]+ \(adv [-\d.]+ fm [-\d.]+ mel [-\d.]+\) "
                      r"disc [-\d.]+ \([\d.]+ s/it\)$")
    assert [int(line.match(x).group(1)) for x in lines] == [1, 2], lines
    assert sorted(p.name for p in out.iterdir()) == ["hift_final.npz", "hift_step2.npz"]

    template = jax.eval_shape(lambda: jhift.init_params(jax.random.PRNGKey(0),
                                                        jax_tiny_config().hift))
    loaded = jckpt.load_params_npz(str(out / "hift_final.npz"), template)
    want_leaves = jax.tree.leaves(template)
    got = jax.tree.leaves(loaded)
    assert len(got) == len(want_leaves)
    with np.load(out / "hift_final.npz") as f:
        saved = dict(f)
    init = flatten_params(init_hift_params(CFG.hift, torch.Generator().manual_seed(42), "cpu"))
    assert set(saved) == set(init)
    flat = flatten_params(jax.tree.map(np.asarray, loaded))
    for k, a in flat.items():
        assert a.shape == saved[k].shape and a.dtype == np.float32, k
        np.testing.assert_array_equal(a, saved[k], err_msg=k)
        assert not np.array_equal(a, n(init[k])), f"{k} did not train"


def test_train_hift_refuses_what_it_does_not_run(tmp_path, capsys):
    base = ["--train_data", str(tmp_path / "missing"), "--output_dir", str(tmp_path)]
    for flag in (["--shard_optimizer"], ["--fsdp"]):
        with pytest.raises(SystemExit) as exc:
            train_hift.main([*base, *flag])
        assert exc.value.code == 2, flag
        err = capsys.readouterr().err
        assert "not ported yet" in err and "slice" in err, (flag, err)
    with pytest.raises(SystemExit) as exc:
        train_hift.main([*base, "--batch_size", "4", "--grad_accum", "3"])
    assert exc.value.code == 2 and "grad_accum" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            train_hift.main(base)


def test_bench_train_gan_smoke_on_cpu(capsys):
    (line,) = bench_train.main(["--which", "gan", "--tiny", "--device", "cpu", "--steps", "1"])
    assert line["metric"] == "train_step_gan" and line["device"] == "cpu"
    assert line["batch"] == [1, SEG, SEG * UP]
    for k in ("step_ms", "gen_ms", "disc_ms", "audio_sec_per_sec"):
        assert line[k] > 0, (k, line)
    assert np.isfinite(line["gen_loss0"])
    assert not {"mfu", "peak_gb", "card", "profile"} & set(line), line
    assert capsys.readouterr().out.count("\n") == 1
