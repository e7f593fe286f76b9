"""The port's saved-dataset reader and writer (utils/hf_dataset.py) against the
`datasets` library, and the two callers it repairs against the JAX package:

- the reader gives `datasets.load_from_disk`'s rows on directories that
  `datasets` wrote: every supported type, None at every level, two shard
  files of several record batches each, and a DatasetDict;
- `datasets` reads the writer's output back with the same features and rows
  as it gives for the same rows saved by itself;
- `shuffle` and `train_test_split` pick the rows `datasets` picks;
- compressed bodies, dictionary-encoded columns and Audio features are
  refused with errors that name them;
- `train.data.load_hf_dataset` gives the JAX package's rows and splits;
- `Frontend.add_speaker_from_dataset` gives the JAX frontend's embedding,
  through an embedding column and through the shuffle-and-select path.

Rows compare exactly (Python values); embeddings within 1e-5 absolute, as in
tests/test_torch_frontend.py."""

import json
import os

import numpy as np
import pyarrow as pa
import pytest

import datasets
from flowmirror_hydravox_tpu.train.data import load_hf_dataset as jax_load_hf_dataset
from flowmirror_hydravox_tpu_torch.config import tiny_config
from flowmirror_hydravox_tpu_torch.frontend.frontend import Frontend
from flowmirror_hydravox_tpu_torch.train.data import load_hf_dataset
from flowmirror_hydravox_tpu_torch.utils import hf_dataset
from tests.test_torch_frontend import _jax_frontend
from tests.test_torch_speech_tokenizer import voiced
from tests.torch_port_util import n  # noqa: F401  (caps torch at one thread)


def _v(dtype):
    return {"dtype": dtype, "_type": "Value"}


def _list(feature, kind="List"):
    return {"feature": feature, "_type": kind}


# one column of each supported type, the reference pipeline's among them
FEATURES = {
    "text": _v("string"), "big_text": _v("large_string"), "blob": _v("binary"),
    "big_blob": _v("large_binary"), "i32": _v("int32"), "i64": _v("int64"),
    "f32": _v("float32"), "f64": _v("float64"), "flag": _v("bool"),
    "audio": {"array": _list(_v("float64")), "sampling_rate": _v("int64")},
    "speech_token": _list(_v("int64")), "embedding": _list(_v("float32")),
    "mel": _list(_list(_v("float32"))), "big_ids": _list(_v("int32"), "LargeList"),
    "nested": _list(_list(_list(_v("int64"))), "LargeList"),
    "pairs": _list({"k": _v("string"), "w": _list(_v("float32"))}),
    "flags": _list(_v("bool")),
}


def _rows(n_rows, seed=0):
    """Seeded rows with None at every level (a row, a struct field, a list
    element) in some of them."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n_rows):
        f32 = rng.standard_normal(3).astype(np.float32)
        rows.append({
            "text": f"row {i}: 你好 hello" if i % 5 != 3 else None,
            "big_text": "x" * i, "blob": bytes(rng.integers(0, 256, i % 4, dtype=np.uint8)),
            "big_blob": None if i % 4 == 1 else b"\x00\xff" * i,
            "i32": int(rng.integers(-2 ** 31, 2 ** 31)), "i64": int(rng.integers(-2 ** 62, 2 ** 62)),
            "f32": float(f32[0]), "f64": None if i % 6 == 2 else float(rng.standard_normal()),
            "flag": bool(i % 3),
            "audio": {"array": rng.standard_normal(4 + i % 5).tolist(),
                      "sampling_rate": 16000 if i % 2 else None},
            "speech_token": rng.integers(0, 6561, 2 + i % 7).tolist(),
            "embedding": None if i % 7 == 4 else f32.tolist(),
            "mel": rng.standard_normal((1 + i % 3, 2)).astype(np.float32).tolist(),
            "big_ids": [int(x) for x in rng.integers(0, 100, i % 4)],
            "nested": [[[i, None], []], None] if i % 2 else [],
            "pairs": [{"k": "a", "w": [0.5, None]}, None, {"k": None, "w": None}],
            "flags": [True, None, False][: i % 4],
        })
    return rows


def _rows_of(ds):
    return [ds[i] for i in range(len(ds))]


def test_reader_equals_datasets(tmp_path, monkeypatch):
    monkeypatch.setattr(datasets.config, "DEFAULT_MAX_BATCH_SIZE", 3)
    rows = _rows(14)
    ref = datasets.Dataset.from_list(rows, features=datasets.Features.from_dict(FEATURES))
    ref.save_to_disk(str(tmp_path / "ds"), num_shards=2)
    shards = sorted(f for f in os.listdir(tmp_path / "ds") if f.endswith(".arrow"))
    assert len(shards) == 2
    for f in shards:  # several record batches in each shard file
        with pa.ipc.open_stream(str(tmp_path / "ds" / f)) as r:
            assert [b.num_rows for b in r] == [3, 3, 1]
    want = datasets.load_from_disk(str(tmp_path / "ds"))
    got = hf_dataset.load_from_disk(str(tmp_path / "ds"))
    assert got.column_names == want.column_names
    assert len(got) == len(want) == 14
    assert _rows_of(got) == _rows_of(want)
    assert list(got) == list(want)
    assert got["speech_token"] == want["speech_token"] and got[-1] == want[-1]

    datasets.DatasetDict({"train": want, "validation": want.select([3, 1])}).save_to_disk(
        str(tmp_path / "dict"))
    got = hf_dataset.load_from_disk(str(tmp_path / "dict"))
    assert isinstance(got, hf_dataset.DatasetDict) and list(got) == ["train", "validation"]
    assert _rows_of(got["validation"]) == [want[3], want[1]]
    assert _rows_of(got["train"]) == _rows_of(want)


@pytest.mark.parametrize("typed", [True, False], ids=["features", "inferred"])
def test_datasets_reads_the_writer(tmp_path, typed):
    """The writer's directory as `datasets` reads it equals the same rows
    saved by `datasets` itself: features (given, or inferred from Python and
    numpy values as pyarrow infers them) and every row."""
    if typed:
        rows, features = _rows(9), FEATURES
        ref = datasets.Dataset.from_list(rows, features=datasets.Features.from_dict(FEATURES))
    else:
        rng = np.random.default_rng(3)
        rows = [{"text": f"t{i}", "speech_token": rng.integers(0, 6561, 3 + i),
                 "embedding": rng.standard_normal(4).astype(np.float32),
                 "mel": rng.standard_normal((2, 3)).astype(np.float32), "n": i,
                 "i32": np.int32(i), "x": float(i) / 3, "ok": bool(i % 2),
                 "audio": {"array": rng.standard_normal(5), "sampling_rate": 24000},
                 "pitch_feat": None if i % 2 else rng.standard_normal(3).astype(np.float32)}
                for i in range(7)]
        features = None
        ref = datasets.Dataset.from_list(rows)
    hf_dataset.save_to_disk(rows, str(tmp_path / "ds"), features=features, num_shards=3,
                            writer_batch_size=2)
    with open(tmp_path / "ds" / "state.json") as f:
        assert [e["filename"] for e in json.load(f)["_data_files"]] == [
            f"data-0000{i}-of-00003.arrow" for i in range(3)]
    back = datasets.load_from_disk(str(tmp_path / "ds"))
    assert back.features == ref.features
    assert _rows_of(back) == _rows_of(ref)
    assert _rows_of(hf_dataset.load_from_disk(str(tmp_path / "ds"))) == _rows_of(ref)


def test_shuffle_and_split_pick_datasets_rows(tmp_path):
    n_rows = 23
    hf_dataset.save_to_disk([{"i": i} for i in range(n_rows)], str(tmp_path / "ds"))
    got = hf_dataset.load_from_disk(str(tmp_path / "ds"))
    want = datasets.load_from_disk(str(tmp_path / "ds"))
    for seed in (0, 42, 1986):
        assert got.shuffle(seed=seed)["i"] == want.shuffle(seed=seed)["i"]
        assert got.shuffle(seed=seed).select(range(5))["i"] == \
            want.shuffle(seed=seed).select(range(5))["i"]
        for size in (0.05, 0.3, 4):
            a, b = got.train_test_split(test_size=size, seed=seed), \
                want.train_test_split(test_size=size, seed=seed)
            assert a["train"]["i"] == b["train"]["i"] and a["test"]["i"] == b["test"]["i"]


def test_refusals_name_what_they_refuse(tmp_path):
    def stream_dir(name, table, **options):
        d = tmp_path / name
        d.mkdir()
        with pa.ipc.new_stream(str(d / "data-00000-of-00001.arrow"), table.schema,
                               options=pa.ipc.IpcWriteOptions(**options)) as w:
            w.write_table(table)
        (d / "state.json").write_text(json.dumps(
            {"_data_files": [{"filename": "data-00000-of-00001.arrow"}]}))
        return str(d)

    with pytest.raises(ValueError, match="compressed"):
        hf_dataset.load_from_disk(stream_dir("zstd", pa.table({"x": np.arange(100)}),
                                             compression="zstd"))
    with pytest.raises(ValueError, match="'x' is dictionary-encoded"):
        hf_dataset.load_from_disk(stream_dir(
            "dict", pa.table({"x": pa.array(["a", "b", "a"]).dictionary_encode()})))
    hf_dataset.save_to_disk([{"audio": {"array": [0.0], "sampling_rate": 16000}}],
                            str(tmp_path / "audio"))
    info = json.loads((tmp_path / "audio" / "dataset_info.json").read_text())
    info["features"]["audio"] = {"sampling_rate": 16000, "_type": "Audio"}
    (tmp_path / "audio" / "dataset_info.json").write_text(json.dumps(info))
    with pytest.raises(ValueError, match="'audio' is a datasets Audio feature"):
        hf_dataset.load_from_disk(str(tmp_path / "audio"))
    with pytest.raises(FileNotFoundError):
        hf_dataset.load_from_disk(str(tmp_path / "missing"))


def test_load_hf_dataset_gives_the_jax_rows_and_splits(tmp_path):
    rng = np.random.default_rng(5)
    rows = [{"text": f"utterance {i}", "speech_token": rng.integers(0, 6561, 4).tolist()}
            for i in range(20)]
    hf_dataset.save_to_disk(rows, str(tmp_path / "plain"))
    datasets.DatasetDict({"train": datasets.Dataset.from_list(rows[:15]),
                          "validation": datasets.Dataset.from_list(rows[15:])}).save_to_disk(
        str(tmp_path / "dict"))
    for path, split in (("plain", 0.0), ("plain", 0.2), ("dict", 0.2)):
        got = load_hf_dataset(str(tmp_path / path), split, seed=42)
        want = jax_load_hf_dataset(str(tmp_path / path), split, seed=42)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert _rows_of(g) == _rows_of(w)


@pytest.fixture(scope="module")
def frontends():
    port = Frontend(tiny_config(), device="cpu")
    return port, _jax_frontend(port)


@pytest.mark.parametrize("column", ["embedding", "audio"])
def test_add_speaker_from_dataset_matches_jax(frontends, tmp_path, column):
    """Enrolment over a directory the port's writer made: the embedding
    column's mean, or 2 of 5 audio rows picked by datasets' shuffle at seed
    42 (max_rows 2)."""
    rng = np.random.default_rng(7)
    if column == "embedding":
        rows = [{"embedding": None if i == 2 else rng.standard_normal(192).astype(np.float32)}
                for i in range(4)]
    else:
        rows = [{"audio": {"array": voiced(16000, 0.5, 20 + i), "sampling_rate": 16000}}
                for i in range(5)]
    hf_dataset.save_to_disk(rows, str(tmp_path / "ds"))
    embs = []
    for fe in frontends:
        n_rows = fe.add_speaker_from_dataset("enrolled", str(tmp_path / "ds"), max_rows=2)
        assert n_rows == (3 if column == "embedding" else 2)
        embs.append(fe.spk2info["enrolled"].embedding)
    np.testing.assert_allclose(embs[0], embs[1], atol=1e-5, rtol=0)
    if column == "audio":  # the two shuffled rows, not the first two
        picked = datasets.load_from_disk(str(tmp_path / "ds")).shuffle(seed=42).select(range(2))
        port = frontends[0]
        mean = np.mean([port.extract_spk_embedding(np.asarray(r["audio"]["array"], np.float32),
                                                   16000) for r in picked], axis=0)
        np.testing.assert_allclose(embs[0], mean, atol=1e-6, rtol=0)
