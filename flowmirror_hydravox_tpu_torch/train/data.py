# Copied from flowmirror_hydravox_tpu/train/data.py; the port keeps its own copy.
"""Training data pipeline: collators, batch iterators and data sources.

Rows come from an HF `datasets` directory (the reference's
extract_speech_token_dataset.py schema: "text", optional "audio" {array,
sampling_rate}, "speech_token", "embedding", "mel"/"mel_feat"), a parquet
shard list, or any iterable of dicts; collators pad each batch to a bucket
grid. Saved datasets are read by the port's own reader
(utils/hf_dataset.py), never by the `datasets` library, which the GPU
machine does not have. A parquet shard still needs `pyarrow`, which that
machine does not have either: there it raises ImportError, a refusal, not
a fallback.

Not ported: speech tokens or speaker embeddings extracted from a row's
audio (no trainer passes the JAX collators an extractor for them): rows
carry both.
"""

from __future__ import annotations

import dataclasses
import logging
import queue
import threading
from typing import Any, Dict, Iterable, Iterator, List, Optional

import numpy as np

from ..frontend.text_norm import normalize
from ..utils import hf_dataset

logger = logging.getLogger("hydravox.data")


def _bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


TEXT_BUCKETS = (32, 64, 128, 256)
SPEECH_BUCKETS = (128, 256, 512, 1024)


def load_hf_dataset(path: str, val_split: float = 0.0, seed: int = 42):
    """load_from_disk + optional auto val split (train_speech_model.py:850-865),
    through utils/hf_dataset.py: the rows and split the `datasets` library
    gives for the same seed."""
    ds = hf_dataset.load_from_disk(path)
    if isinstance(ds, hf_dataset.DatasetDict):
        if "train" in ds:
            train = ds["train"]
            val = ds.get("validation") or ds.get("test")
            if val is not None:
                return train, val
            ds = train
    if val_split > 0:
        split = ds.train_test_split(test_size=val_split, seed=seed)
        return split["train"], split["test"]
    return ds, None


@dataclasses.dataclass
class LLMCollator:
    """Rows -> padded LLM batch {text_token, text_len, speech_token, speech_len}.

    Text is normalized + tokenized here (reference does TN + phoneme-sub aug
    in the collator, train_speech_model.py:550-565); speech tokens come from
    the dataset."""

    tokenizer: Any
    text_buckets: tuple = TEXT_BUCKETS
    speech_buckets: tuple = SPEECH_BUCKETS
    # phoneme-substitution augmentation (train/phoneme_aug.PhonemeAugmenter),
    # applied to every collated text after normalization
    phoneme_aug: Optional[Any] = None

    def __call__(self, rows: List[Dict]) -> Dict[str, np.ndarray]:
        text_tokens, speech_tokens = [], []
        for row in rows:
            if "text_token" in row:
                tt = np.asarray(row["text_token"], np.int32)
            else:
                text = normalize(row["text"])
                if self.phoneme_aug is not None:
                    text = self.phoneme_aug(text)
                tt = np.asarray(self.tokenizer.encode(text), np.int32)
            text_tokens.append(tt)

            if row.get("speech_token") is None or len(row["speech_token"]) == 0:
                raise ValueError("row has no speech_token")
            speech_tokens.append(np.asarray(row["speech_token"], np.int32))

        lt = _bucket(max(len(t) for t in text_tokens), self.text_buckets)
        ls = _bucket(max(len(t) for t in speech_tokens), self.speech_buckets)
        b = len(rows)
        batch = {
            "text_token": np.zeros((b, lt), np.int32),
            "text_len": np.zeros((b,), np.int32),
            "speech_token": np.zeros((b, ls), np.int32),
            "speech_len": np.zeros((b,), np.int32),
        }
        for i, (tt, st) in enumerate(zip(text_tokens, speech_tokens)):
            tt, st = tt[:lt], st[:ls]
            batch["text_token"][i, : len(tt)] = tt
            batch["text_len"][i] = len(tt)
            batch["speech_token"][i, : len(st)] = st
            batch["speech_len"][i] = len(st)
        return batch


@dataclasses.dataclass
class DPOCollator:
    """Rows -> padded DPO batch {text_token, text_len, chosen_token,
    chosen_len, rejected_token, rejected_len}.

    Chosen tokens come from "speech_token", rejected from
    "reject_speech_token" (reference dataset/processor.py:432-438 padding
    for dpo=True batches); both pad to one speech bucket."""

    tokenizer: Any
    text_buckets: tuple = TEXT_BUCKETS
    speech_buckets: tuple = SPEECH_BUCKETS

    def __call__(self, rows: List[Dict]) -> Dict[str, np.ndarray]:
        text_tokens, chosen, rejected = [], [], []
        for row in rows:
            if "text_token" in row:
                tt = np.asarray(row["text_token"], np.int32)
            else:
                tt = np.asarray(self.tokenizer.encode(normalize(row["text"])), np.int32)
            text_tokens.append(tt)
            chosen.append(np.asarray(row["speech_token"], np.int32))
            rejected.append(np.asarray(row["reject_speech_token"], np.int32))

        lt = _bucket(max(len(t) for t in text_tokens), self.text_buckets)
        ls = _bucket(max(len(t) for t in chosen + rejected), self.speech_buckets)
        b = len(rows)
        batch = {
            "text_token": np.zeros((b, lt), np.int32),
            "text_len": np.zeros((b,), np.int32),
            "chosen_token": np.zeros((b, ls), np.int32),
            "chosen_len": np.zeros((b,), np.int32),
            "rejected_token": np.zeros((b, ls), np.int32),
            "rejected_len": np.zeros((b,), np.int32),
        }
        for i, (tt, ch, rj) in enumerate(zip(text_tokens, chosen, rejected)):
            tt, ch, rj = tt[:lt], ch[:ls], rj[:ls]
            batch["text_token"][i, : len(tt)] = tt
            batch["text_len"][i] = len(tt)
            batch["chosen_token"][i, : len(ch)] = ch
            batch["chosen_len"][i] = len(ch)
            batch["rejected_token"][i, : len(rj)] = rj
            batch["rejected_len"][i] = len(rj)
        return batch


@dataclasses.dataclass
class FlowCollator:
    """Rows -> padded flow batch {speech_token, token_len, speech_feat,
    feat_len, embedding} (train_speech_model.py:593-667).

    Mel comes from the dataset ("mel"/"mel_feat") or is extracted from
    "audio" with the native 24 kHz pipeline; the mel length is snapped to
    2x the token count (token_mel_ratio)."""

    token_buckets: tuple = SPEECH_BUCKETS
    mel_extract_fn: Optional[Any] = None  # wav, sr -> (Tm, 80)
    token_mel_ratio: int = 2

    def __call__(self, rows: List[Dict]) -> Dict[str, np.ndarray]:
        toks, mels, embs = [], [], []
        for row in rows:
            st = np.asarray(row["speech_token"], np.int32)
            mel = row.get("mel", row.get("mel_feat"))
            if mel is None:
                audio = row["audio"]
                mel = self.mel_extract_fn(np.asarray(audio["array"]), audio["sampling_rate"])
            mel = np.asarray(mel, np.float32)
            emb = row["embedding"]
            # snap mel length to ratio * tokens (flow.py:337-344 interpolates;
            # we trim to the shorter to keep alignment exact)
            n = min(len(st), mel.shape[0] // self.token_mel_ratio)
            toks.append(st[:n])
            mels.append(mel[: n * self.token_mel_ratio])
            embs.append(np.asarray(emb, np.float32).reshape(-1)[:192])

        lt = _bucket(max(len(t) for t in toks), self.token_buckets)
        lm = lt * self.token_mel_ratio
        b = len(rows)
        batch = {
            "speech_token": np.zeros((b, lt), np.int32),
            "token_len": np.zeros((b,), np.int32),
            "speech_feat": np.zeros((b, lm, 80), np.float32),
            "feat_len": np.zeros((b,), np.int32),
            "embedding": np.zeros((b, 192), np.float32),
        }
        for i, (st, mel, emb) in enumerate(zip(toks, mels, embs)):
            batch["speech_token"][i, : len(st)] = st
            batch["token_len"][i] = len(st)
            batch["speech_feat"][i, : mel.shape[0]] = mel
            batch["feat_len"][i] = mel.shape[0]
            batch["embedding"][i] = emb
        return batch


def shard_list_iterator(
    list_file: str,
    rank: int = 0,
    world_size: int = 1,
    worker: int = 0,
    num_workers: int = 1,
    seed: int = 0,
    epochs: Optional[int] = None,
    shuffle: bool = True,
) -> Iterator[Dict]:
    """Parquet shard-list chain (reference dataset/dataset.py:51-122 +
    dataset/processor.py:29 parquet_opener): a text file with one shard path
    per line (parquet file or HF-dataset dir) -> epoch-seeded shuffle ->
    two-level rank x worker modulo sharding -> open -> yield row dicts.
    A parquet shard is read with `pyarrow.parquet` (ImportError where
    pyarrow is absent, as on the GPU machine); a dataset directory with
    utils/hf_dataset.py."""
    with open(list_file) as f:
        shards = [line.strip() for line in f if line.strip()]
    epoch = 0
    while epochs is None or epoch < epochs:
        order = list(range(len(shards)))
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        # rank-level then worker-level modulo sharding (dataset.py:51-122)
        mine = [shards[i] for j, i in enumerate(order) if j % world_size == rank]
        mine = [s for j, s in enumerate(mine) if j % num_workers == worker]
        for shard in mine:
            if shard.endswith(".parquet"):
                import pyarrow.parquet as pq

                table = pq.read_table(shard)
                cols = table.column_names
                for i in range(table.num_rows):
                    yield {c: table.column(c)[i].as_py() for c in cols}
            else:
                for row in hf_dataset.load_from_disk(shard):
                    yield row
        epoch += 1


def dynamic_batch_iterator(
    data: Iterable[Dict],
    collator,
    max_frames_in_batch: int = 12000,
    length_fn=None,
    pad_batch_pow2: bool = True,
    min_batch_multiple: int = 1,
) -> Iterator[Dict[str, np.ndarray]]:
    """Token/frame-budget batching (reference processor.py:324-350
    dynamic_batch): accumulate rows until padded frames
    (longest * (batch+1)) would exceed the budget, then emit.

    `pad_batch_pow2` zero-pads the batch dim up to the next power of two (at
    least `min_batch_multiple`, the data-parallel shard count), as the JAX
    package pads it for its compiled programs; padded rows carry zero
    lengths and contribute nothing to masked losses."""
    if length_fn is None:
        def length_fn(row):
            if row.get("mel") is not None:
                return len(row["mel"])
            if row.get("speech_token") is not None:
                return len(row["speech_token"])
            return len(row.get("text", ""))

    def emit(rows):
        batch = collator(rows)
        if pad_batch_pow2:
            b = len(rows)
            target = max(min_batch_multiple, 1 << (b - 1).bit_length())
            if target > b:
                batch = {
                    k: np.concatenate(
                        [v, np.zeros((target - b,) + v.shape[1:], v.dtype)]
                    )
                    for k, v in batch.items()
                }
        return batch

    buf: List[Dict] = []
    longest = 0
    for row in data:
        n = int(length_fn(row))
        longest = max(longest, n)
        if buf and longest * (len(buf) + 1) > max_frames_in_batch:
            yield emit(buf)
            buf = [row]
            longest = n
        else:
            buf.append(row)
    if buf:
        yield emit(buf)


class Prefetch:
    """Iterate `batches` from a daemon host thread, up to `maxsize` items
    ahead (the JAX trainers' host prefetch, which overlaps synthesis with the
    device step). An exception in the producer is raised to the consumer,
    where the JAX thread would die and leave the trainer waiting; `close()`
    (or leaving the `with` block) lets the producer stop at its next item."""

    _END = object()

    def __init__(self, batches: Iterable, maxsize: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=maxsize)
        self._stop = threading.Event()
        threading.Thread(target=self._feed, args=(batches,), daemon=True).start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _feed(self, batches):
        try:
            for item in batches:
                if not self._put(item):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            self._put(_Failed(e))
            return
        self._put(self._END)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._END:
                return
            if isinstance(item, _Failed):
                raise item.error
            yield item

    def close(self):
        self._stop.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@dataclasses.dataclass
class _Failed:
    error: Exception


def static_batch_iterable(
    data: Iterable[Dict], collator, batch_size: int, drop_last: bool = True
) -> Iterator[Dict[str, np.ndarray]]:
    """Fixed-size batching over an iterable source (processor.py:304-321)."""
    buf: List[Dict] = []
    for row in data:
        buf.append(row)
        if len(buf) >= batch_size:
            yield collator(buf)
            buf = []
    if buf and not drop_last:
        yield collator(buf)


def iterate_rows(dataset, seed: int = 0, epochs: Optional[int] = None,
                 shuffle: bool = True) -> Iterator[Dict]:
    """Epoch-seeded shuffled row stream over an indexable dataset."""
    n = len(dataset)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        for i in order:
            yield dataset[int(i)]
        epoch += 1


def make_batch_source(
    collator,
    batch_size: int,
    train_data: Optional[str] = None,
    shard_list: Optional[str] = None,
    batch_type: str = "static",
    max_frames_in_batch: int = 12000,
    seed: int = 0,
    epochs: Optional[int] = None,
    val_split: float = 0.0,
    min_batch_multiple: int = 1,
    rank: int = 0,
    world_size: int = 1,
):
    """CLI-facing data source builder: HF-dataset dir (default) or parquet
    shard-list chain; static (fixed batch) or dynamic (frame-budget)
    batching. Returns (batch_iterator, val_dataset_or_None)."""
    if shard_list:
        rows = shard_list_iterator(shard_list, rank=rank, world_size=world_size,
                                   seed=seed, epochs=epochs)
        if batch_type == "dynamic":
            return dynamic_batch_iterator(
                rows, collator, max_frames_in_batch,
                min_batch_multiple=min_batch_multiple), None
        return static_batch_iterable(rows, collator, batch_size), None
    train_ds, val_ds = load_hf_dataset(train_data, val_split, seed)
    if batch_type == "dynamic":
        rows = iterate_rows(train_ds, seed=seed, epochs=epochs)
        return dynamic_batch_iterator(
            rows, collator, max_frames_in_batch,
            min_batch_multiple=min_batch_multiple), val_ds
    return batch_iterator(train_ds, collator, batch_size, seed=seed, epochs=epochs), val_ds


def batch_iterator(
    dataset,
    collator,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 0,
    epochs: Optional[int] = None,
    drop_last: bool = True,
    sort_window: int = 512,
) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffle(epoch-seeded) -> local length-sort window -> fixed-size batches.

    The sort window groups similar lengths so bucket padding waste stays low
    (the reference's shuffle(10k)+sort(500) pattern, dataset/processor.py)."""
    n = len(dataset)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + epoch).shuffle(order)
        for wstart in range(0, n, sort_window):
            widx = order[wstart : wstart + sort_window]
            rows = [dataset[int(i)] for i in widx]
            key = (
                (lambda r: len(r.get("speech_token", r.get("text", ""))))
            )
            rows.sort(key=key)
            for bstart in range(0, len(rows), batch_size):
                chunk = rows[bstart : bstart + batch_size]
                if drop_last and len(chunk) < batch_size:
                    continue
                yield collator(chunk)
        epoch += 1
