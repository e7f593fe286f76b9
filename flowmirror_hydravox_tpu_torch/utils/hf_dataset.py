"""Saved Hugging Face datasets, read and written without the `datasets`
library (which, with `pyarrow`, the GPU machine does not have).

`datasets.Dataset.save_to_disk` writes a directory of

  - `data-<i>-of-<n>.arrow`: Arrow IPC *stream* files. Each is a sequence of
    encapsulated messages: the continuation marker `ff ff ff ff`, an int32
    metadata length, a flatbuffer `Message` padded to 8 bytes, then the
    message body (its buffers, each padded to 8 bytes). The first message is
    the `Schema`, the rest `RecordBatch`es (`writer_batch_size` rows each);
    the stream ends with `ff ff ff ff 00 00 00 00`;
  - `state.json`, whose `_data_files` lists the shards in row order;
  - `dataset_info.json`, whose `features` give the `datasets` types;

and `DatasetDict.save_to_disk` a `dataset_dict.json` ({"splits": [...]})
beside one such directory per split. `load_from_disk` reads both layouts
into a `Dataset` (rows as `datasets` gives them: dicts of Python values) or a
`DatasetDict`, going by `state.json` and `dataset_dict.json` alone, so other
files in the directory (a job's log, `corpus_stats.json`) are ignored;
`save_to_disk` and `save_dataset_dict_json` write both, and what they write
`datasets.load_from_disk` reads back unchanged. `concatenate_datasets`
chains datasets row for row, as the library's does along axis 0. The
flatbuffer tables are those of Arrow's `Message.fbs` and `Schema.fbs`
(metadata version V5).

Types: signed and unsigned ints, float16/32/64, bool, utf8 and large_utf8,
binary and large_binary, null, list and large_list (nested to any depth)
and struct, each with a validity bitmap.
Refused with an error that names them: compressed bodies, dictionary-encoded
columns, big-endian streams, other Arrow types, and features of `_type`
Audio, Image or Video (they need the library's decoders).

`Dataset.shuffle` and `train_test_split` pick the rows `datasets` picks for
the same seed: both take `np.random.default_rng(seed).permutation(n)`
(arrow_dataset.py, `shuffle` and `train_test_split`), the test split being
its first ceil(test_size * n) indices.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
import uuid
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np

CONTINUATION = b"\xff\xff\xff\xff"
METADATA_V5 = 4
# MessageHeader union
_SCHEMA, _DICTIONARY_BATCH, _RECORD_BATCH = 1, 2, 3
# Type union (Schema.fbs)
_TYPE_IDS = {"null": 1, "int": 2, "float": 3, "binary": 4, "utf8": 5, "bool": 6, "list": 12,
             "struct": 13, "large_binary": 19, "large_utf8": 20, "large_list": 21}
_TYPE_NAMES = {v: k for k, v in _TYPE_IDS.items()}
_FLOAT_BITS = {0: 16, 1: 32, 2: 64}  # Precision HALF, SINGLE, DOUBLE
_UNDECODED_FEATURES = ("Audio", "Image", "Video")


# -- Arrow types ----------------------------------------------------------

class ArrowType:
    """An Arrow type: `kind` (a key of `_TYPE_IDS`), `bits` and `signed`
    for numbers, and `children`, a tuple of (name, ArrowType) (one "item"
    for the list kinds)."""

    __slots__ = ("kind", "bits", "signed", "children")

    def __init__(self, kind: str, bits: int = 0, signed: bool = True, children: tuple = ()):
        self.kind, self.bits, self.signed = kind, bits, signed
        self.children = tuple(children)

    def __eq__(self, other):
        return isinstance(other, ArrowType) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def _key(self):
        return (self.kind, self.bits, self.signed, self.children)

    def __repr__(self):
        if self.kind in ("int", "float"):
            return f"{'' if self.signed or self.kind == 'float' else 'u'}{self.kind}{self.bits}"
        if self.children:
            return f"{self.kind}<{', '.join(f'{n}: {t!r}' for n, t in self.children)}>"
        return self.kind

    @property
    def item(self) -> "ArrowType":
        return self.children[0][1]

    @property
    def numpy_dtype(self) -> np.dtype:
        if self.kind == "float":
            return np.dtype(f"<f{self.bits // 8}")
        return np.dtype(f"<{'i' if self.signed else 'u'}{self.bits // 8}")


def _list_of(item: ArrowType, large: bool = False) -> ArrowType:
    return ArrowType("large_list" if large else "list", children=(("item", item),))


_VALUE_DTYPES = {
    **{f"int{b}": ArrowType("int", b) for b in (8, 16, 32, 64)},
    **{f"uint{b}": ArrowType("int", b, signed=False) for b in (8, 16, 32, 64)},
    **{f"float{b}": ArrowType("float", b) for b in (16, 32, 64)},
    "bool": ArrowType("bool"), "string": ArrowType("utf8"), "large_string": ArrowType("large_utf8"),
    "binary": ArrowType("binary"), "large_binary": ArrowType("large_binary"),
    "null": ArrowType("null"),
}
_DTYPE_NAMES = {t: name for name, t in _VALUE_DTYPES.items()}


def features_to_type(feature) -> ArrowType:
    """A `datasets` feature, as dataset_info.json stores it, as an Arrow
    type: `Value`, `List` / `LargeList` / the older `Sequence` and `[f]`,
    and a dict for a struct."""
    if isinstance(feature, list):
        return _list_of(features_to_type(feature[0]))
    kind = feature.get("_type")
    if kind is None:
        return ArrowType("struct", children=tuple(
            (name, features_to_type(f)) for name, f in feature.items()))
    if kind in _UNDECODED_FEATURES:
        raise ValueError(f"a feature of _type {kind} needs the datasets library's decoder")
    if kind == "Value":
        if feature["dtype"] not in _VALUE_DTYPES:
            raise ValueError(f"unsupported Value dtype {feature['dtype']!r}")
        return _VALUE_DTYPES[feature["dtype"]]
    if kind in ("List", "LargeList", "Sequence"):
        if feature.get("length", -1) != -1:
            raise ValueError("fixed-length list features are not supported")
        return _list_of(features_to_type(feature["feature"]), large=(kind == "LargeList"))
    raise ValueError(f"unsupported feature _type {kind!r}")


def type_to_features(t: ArrowType):
    """The `datasets` feature (dataset_info.json form) of an Arrow type, as
    `datasets.Features.from_arrow_schema` infers it."""
    if t.kind == "struct":
        return {name: type_to_features(c) for name, c in t.children}
    if t.kind in ("list", "large_list"):
        return {"feature": type_to_features(t.item),
                "_type": "LargeList" if t.kind == "large_list" else "List"}
    return {"dtype": _DTYPE_NAMES[t], "_type": "Value"}


def _check_features(features: dict, where: str):
    """Refuse a dataset whose features need the `datasets` decoders."""
    def walk(f, name):
        if isinstance(f, list):
            for g in f:
                walk(g, name)
        elif isinstance(f, dict):
            if f.get("_type") in _UNDECODED_FEATURES:
                raise ValueError(f"{where}: column {name!r} is a datasets {f['_type']} feature, "
                                 "which needs the datasets library's decoder")
            for k, g in f.items():
                if isinstance(g, (dict, list)):
                    walk(g, name)
    for name, f in (features or {}).items():
        walk(f, name)


# -- flatbuffers ----------------------------------------------------------

class _Table:
    """A flatbuffer table at `pos` of `buf` (read only)."""

    def __init__(self, buf, pos: int):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vlen = struct.unpack_from("<H", buf, self.vt)[0]

    def _off(self, slot: int) -> int:
        o = 4 + 2 * slot
        return struct.unpack_from("<H", self.buf, self.vt + o)[0] if o < self.vlen else 0

    def scalar(self, slot: int, fmt: str, default=0):
        o = self._off(slot)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + o)[0] if o else default

    def _ref(self, slot: int) -> Optional[int]:
        o = self._off(slot)
        if not o:
            return None
        p = self.pos + o
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, slot: int) -> Optional["_Table"]:
        p = self._ref(slot)
        return None if p is None else _Table(self.buf, p)

    def string(self, slot: int) -> Optional[str]:
        p = self._ref(slot)
        if p is None:
            return None
        n = struct.unpack_from("<I", self.buf, p)[0]
        return bytes(self.buf[p + 4:p + 4 + n]).decode("utf-8")

    def tables(self, slot: int) -> List["_Table"]:
        p = self._ref(slot)
        if p is None:
            return []
        n = struct.unpack_from("<I", self.buf, p)[0]
        out = []
        for i in range(n):
            e = p + 4 + 4 * i
            out.append(_Table(self.buf, e + struct.unpack_from("<I", self.buf, e)[0]))
        return out

    def structs(self, slot: int, fmt: str) -> List[tuple]:
        p = self._ref(slot)
        if p is None:
            return []
        n = struct.unpack_from("<I", self.buf, p)[0]
        size = struct.calcsize("<" + fmt)
        return list(struct.iter_unpack("<" + fmt, bytes(self.buf[p + 4:p + 4 + n * size])))


class _T:
    """A flatbuffer table to write: `fields` is a list of (slot, kind, value)
    with kind a struct format ("b", "h", "i", "q"), "table", "str", "tables"
    (a vector of _T) or "structs" (a vector of 16-byte structs, as bytes)."""

    def __init__(self, *fields):
        self.fields = [f for f in fields if f[2] is not None]


class _FlatWriter:
    """Writes flatbuffers front to back: each table's vtable just before it
    and every object it references after it (uoffsets point forward)."""

    def __init__(self):
        self.buf = bytearray()

    def _pad(self, align: int, extra: int = 0):
        self.buf += b"\0" * (-(len(self.buf) + extra) % align)

    def finish(self, root: _T) -> bytes:
        self.buf += b"\0" * 4
        struct.pack_into("<I", self.buf, 0, self._table(root))
        self._pad(8)
        return bytes(self.buf)

    def _table(self, t: _T) -> int:
        inline = sorted(t.fields, key=lambda f: -(struct.calcsize(f[1]) if len(f[1]) == 1 else 4))
        nslots = max((f[0] for f in t.fields), default=-1) + 1
        self._pad(2)
        vt = len(self.buf)
        self.buf += b"\0" * (4 + 2 * nslots)
        self._pad(8)
        start = len(self.buf)
        offsets, off = {}, 4
        for slot, kind, _ in inline:
            size = struct.calcsize(kind) if len(kind) == 1 else 4
            off += -off % size
            offsets[slot] = off
            off += size
        size = off + (-off % 4)
        struct.pack_into("<HH", self.buf, vt, 4 + 2 * nslots, size)
        for slot, o in offsets.items():
            struct.pack_into("<H", self.buf, vt + 4 + 2 * slot, o)
        self.buf += b"\0" * size
        struct.pack_into("<i", self.buf, start, start - vt)
        refs = []
        for slot, kind, value in inline:
            if len(kind) == 1:
                struct.pack_into("<" + kind, self.buf, start + offsets[slot], value)
            else:
                refs.append((start + offsets[slot], kind, value))
        for at, kind, value in refs:
            self._patch(at, self._object(kind, value))
        return start

    def _patch(self, at: int, target: int):
        struct.pack_into("<I", self.buf, at, target - at)

    def _object(self, kind: str, value) -> int:
        if kind == "table":
            return self._table(value)
        if kind == "str":
            data = value.encode("utf-8")
            self._pad(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(data)) + data + b"\0"
            return pos
        if kind == "tables":
            self._pad(4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", len(value)) + b"\0" * (4 * len(value))
            for i, child in enumerate(value):
                self._patch(pos + 4 + 4 * i, self._table(child))
            return pos
        if kind == "structs":  # (count, packed bytes) of 8-byte-aligned structs
            count, data = value
            self._pad(8, extra=4)
            pos = len(self.buf)
            self.buf += struct.pack("<I", count) + data
            return pos
        raise ValueError(kind)


# -- the schema -----------------------------------------------------------

def _read_field(f: _Table) -> tuple:
    name = f.string(0) or ""
    if f.table(4) is not None:
        raise ValueError(f"column {name!r} is dictionary-encoded, which this reader does not read")
    type_id = f.scalar(2, "B")
    kind = _TYPE_NAMES.get(type_id)
    if kind is None:
        raise ValueError(f"column {name!r} has Arrow type id {type_id}, which this reader "
                         "does not read")
    tt = f.table(3)
    children = tuple(_read_field(c) for c in f.tables(5))
    if kind == "int":
        t = ArrowType("int", tt.scalar(0, "i"), bool(tt.scalar(1, "B")))
    elif kind == "float":
        t = ArrowType("float", _FLOAT_BITS[tt.scalar(0, "h")])
    else:
        t = ArrowType(kind, children=children if kind in (
            "list", "large_list", "struct") else ())
    return name, t


def _field_table(name: str, t: ArrowType) -> _T:
    if t.kind == "int":
        type_table = _T((0, "i", t.bits), (1, "B", int(t.signed)))
    elif t.kind == "float":
        type_table = _T((0, "h", {16: 0, 32: 1, 64: 2}[t.bits]))
    else:
        type_table = _T()
    children = [_field_table(n, c) for n, c in t.children]
    return _T((0, "str", name), (1, "B", 1), (2, "B", _TYPE_IDS[t.kind]), (3, "table", type_table),
              (5, "tables", children))


def _message(header_type: int, header: _T, body_length: int) -> bytes:
    meta = _FlatWriter().finish(_T((0, "h", METADATA_V5), (1, "B", header_type),
                                (2, "table", header), (3, "q", body_length)))
    return CONTINUATION + struct.pack("<i", len(meta)) + meta


# -- reading --------------------------------------------------------------

class _Column:
    """One column of one record batch, decoded to numpy views: `valid` (a
    bool array, or None when nothing is null), `values` for numbers and
    bools, `offsets` + `data` for strings and binaries, `offsets` + `child`
    for lists, `children` for structs."""

    __slots__ = ("type", "length", "valid", "values", "offsets", "data", "child", "children")

    def __init__(self, t: ArrowType, length: int):
        self.type, self.length = t, length
        self.valid = self.values = self.offsets = self.data = self.child = None
        self.children = ()

    def value(self, i: int):
        if self.valid is not None and not self.valid[i]:
            return None
        kind = self.type.kind
        if kind in ("int", "float", "bool"):
            return self.values[i].item()
        if kind == "null":
            return None
        if kind == "struct":
            return {name: c.value(i) for (name, _), c in zip(self.type.children, self.children)}
        lo, hi = int(self.offsets[i]), int(self.offsets[i + 1])
        if kind in ("utf8", "large_utf8"):
            return bytes(self.data[lo:hi]).decode("utf-8")
        if kind in ("binary", "large_binary"):
            return bytes(self.data[lo:hi])
        child = self.child
        if child.type.kind in ("int", "float", "bool") and child.valid is None:
            return child.values[lo:hi].tolist()
        return [child.value(j) for j in range(lo, hi)]


class _BatchReader:
    def __init__(self, body, nodes, buffers):
        self.body, self.nodes, self.buffers = body, iter(nodes), iter(buffers)

    def _buffer(self):
        off, n = next(self.buffers)
        return self.body[off:off + n]

    def _validity(self, length: int, null_count: int):
        buf = self._buffer()
        if null_count == 0:
            return None
        bits = np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")
        return bits[:length].astype(bool)

    def column(self, t: ArrowType) -> _Column:
        length, null_count = next(self.nodes)
        col = _Column(t, length)
        if t.kind == "null":
            col.valid = np.zeros(length, bool)
            return col
        col.valid = self._validity(length, null_count)
        if t.kind == "bool":
            col.values = np.unpackbits(np.frombuffer(self._buffer(), np.uint8),
                                       bitorder="little")[:length].astype(bool)
        elif t.kind in ("int", "float"):
            col.values = np.frombuffer(self._buffer(), t.numpy_dtype, count=length)
        elif t.kind == "struct":
            col.children = tuple(self.column(c) for _, c in t.children)
        else:
            wide = t.kind.startswith("large_")
            col.offsets = np.frombuffer(self._buffer(), np.int64 if wide else np.int32,
                                        count=length + 1)
            if t.kind in ("list", "large_list"):
                col.child = self.column(t.item)
            else:
                col.data = self._buffer()
        return col


def _read_stream(path: str):
    """(fields, [(length, [columns])]) of one Arrow IPC stream file."""
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if size else b""
    view = memoryview(buf)
    pos, fields, batches = 0, None, []
    while pos + 8 <= len(view):
        if bytes(view[pos:pos + 4]) != CONTINUATION:
            raise ValueError(f"{path}: not an Arrow IPC stream at byte {pos}")
        n = struct.unpack_from("<i", view, pos + 4)[0]
        pos += 8
        if n == 0:
            break
        msg = _Table(view[pos:pos + n], struct.unpack_from("<I", view, pos)[0])
        pos += n
        body_len = msg.scalar(3, "q")
        body = view[pos:pos + body_len]
        pos += body_len
        kind, header = msg.scalar(1, "B"), msg.table(2)
        if kind == _SCHEMA:
            if header.scalar(0, "h") != 0:
                raise ValueError(f"{path}: big-endian Arrow data is not read")
            fields = [_read_field(f) for f in header.tables(1)]
        elif kind == _DICTIONARY_BATCH:
            raise ValueError(f"{path}: dictionary batches (dictionary-encoded columns) "
                             "are not read")
        elif kind == _RECORD_BATCH:
            if header.table(3) is not None:
                raise ValueError(f"{path}: compressed record batch bodies are not read")
            reader = _BatchReader(body, header.structs(1, "qq"), header.structs(2, "qq"))
            batches.append((header.scalar(0, "q"), [reader.column(t) for _, t in fields]))
        else:
            raise ValueError(f"{path}: Arrow message type {kind} is not read")
    if fields is None:
        raise ValueError(f"{path}: no Arrow schema message")
    return fields, batches


# -- datasets -------------------------------------------------------------

class Dataset:
    """Rows of saved record batches, in order, through an optional index
    mapping (`select`, `shuffle`), as `datasets.Dataset` gives them: `len`,
    `ds[i]` (a dict), `ds[column]` (a list), iteration and `column_names`."""

    def __init__(self, fields, batches, indices: Optional[np.ndarray] = None):
        self._fields, self._batches = fields, batches
        self._starts = np.cumsum([0] + [n for n, _ in batches])
        self._indices = indices

    @property
    def column_names(self) -> List[str]:
        return [name for name, _ in self._fields]

    @property
    def features(self) -> dict:
        """The columns' `datasets` features (the dataset_info.json form)."""
        return {name: type_to_features(t) for name, t in self._fields}

    def __len__(self) -> int:
        return int(self._starts[-1]) if self._indices is None else len(self._indices)

    def _row(self, i: int) -> dict:
        b = int(np.searchsorted(self._starts, i, side="right")) - 1
        cols = self._batches[b][1]
        j = i - int(self._starts[b])
        return {name: c.value(j) for (name, _), c in zip(self._fields, cols)}

    def __getitem__(self, key):
        if isinstance(key, str):
            return [row[key] for row in self]
        n = len(self)
        i = int(key)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(f"index {key} out of range for a dataset of {n} rows")
        return self._row(i if self._indices is None else int(self._indices[i]))

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self[i]

    def select(self, indices: Iterable[int]) -> "Dataset":
        idx = np.asarray(list(indices) if not isinstance(indices, np.ndarray) else indices,
                         np.int64).reshape(-1)
        n = len(self)
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise IndexError(f"select: indices out of range for a dataset of {n} rows")
        base = idx if self._indices is None else self._indices[idx]
        return Dataset(self._fields, self._batches, base)

    def shuffle(self, seed: Optional[int] = None) -> "Dataset":
        return self.select(np.random.default_rng(seed).permutation(len(self)))

    def train_test_split(self, test_size, seed: Optional[int] = None) -> "DatasetDict":
        """datasets' shuffled split (arrow_dataset.py `train_test_split`): a
        float `test_size` is a share, rounded up, an int a count; the test
        rows are the permutation's first n_test, the train rows the rest."""
        n = len(self)
        if isinstance(test_size, float):
            ok, n_test = 0 < test_size < 1, math.ceil(test_size * n)
        else:
            ok, n_test = 0 < test_size < n, int(test_size)
        if not ok or n_test >= n:
            raise ValueError(f"test_size={test_size} should be either positive and smaller than "
                             f"the number of samples {n} or a float in the (0, 1) range")
        perm = np.random.default_rng(seed).permutation(n)
        return DatasetDict(train=self.select(perm[n_test:]), test=self.select(perm[:n_test]))


class DatasetDict(dict):
    """Named splits, each a `Dataset` (`datasets.DatasetDict`)."""

    @property
    def column_names(self) -> Dict[str, List[str]]:
        return {k: v.column_names for k, v in self.items()}


def concatenate_datasets(parts: List[Dataset]) -> Dataset:
    """The rows of `parts`, one part after the other
    (`datasets.concatenate_datasets` along axis 0). Columns keep the first
    part's order, those that only later parts have follow, and a part
    without a column gives None there. A column whose type differs between
    two parts (neither null) raises ValueError naming it, as the library
    does."""
    if not parts:
        raise ValueError("concatenate_datasets needs at least one dataset")
    types: Dict[str, ArrowType] = {}
    for part in parts:
        if not isinstance(part, Dataset):
            raise ValueError(f"can only concatenate Datasets, not a {type(part).__name__}")
        for name, t in part._fields:
            have = types.get(name)
            if have is None or have.kind == "null":
                types[name] = t
            elif t != have and t.kind != "null":
                raise ValueError(f"The features can't be aligned because the key {name} has type "
                                 f"{type_to_features(t)} in one dataset and "
                                 f"{type_to_features(have)} in another")
    fields = list(types.items())
    batches, indices, start, direct = [], [], 0, True
    for part in parts:
        cols_of = dict(zip(part.column_names, range(len(part._fields))))
        for length, cols in part._batches:
            batches.append((length, [cols[cols_of[name]] if name in cols_of
                                     else _Column(ArrowType("null"), length)
                                     for name, _ in fields]))
        n_rows = int(part._starts[-1])
        direct = direct and part._indices is None
        indices.append(start + (np.arange(n_rows) if part._indices is None else part._indices))
        start += n_rows
    return Dataset(fields, batches, None if direct else np.concatenate(indices))


def load_from_disk(path: str):
    """The `Dataset` or `DatasetDict` that `save_to_disk` (this module's or
    the `datasets` library's) wrote to `path`."""
    if os.path.isfile(os.path.join(path, "dataset_dict.json")):
        with open(os.path.join(path, "dataset_dict.json")) as f:
            splits = json.load(f)["splits"]
        return DatasetDict({s: load_from_disk(os.path.join(path, s)) for s in splits})
    state_path = os.path.join(path, "state.json")
    if not os.path.isfile(state_path):
        raise FileNotFoundError(f"{path} is neither a saved Dataset nor a saved DatasetDict "
                                "(no state.json, no dataset_dict.json)")
    with open(state_path) as f:
        state = json.load(f)
    info_path = os.path.join(path, "dataset_info.json")
    if os.path.isfile(info_path):
        with open(info_path) as f:
            _check_features(json.load(f).get("features"), path)
    fields, batches = None, []
    for entry in state["_data_files"]:
        shard_fields, shard_batches = _read_stream(os.path.join(path, entry["filename"]))
        if fields is not None and shard_fields != fields:
            raise ValueError(f"{path}: shard {entry['filename']} has another schema")
        fields = shard_fields
        batches += shard_batches
    if fields is None:
        raise ValueError(f"{path}: state.json lists no data files")
    return Dataset(fields, batches)


# -- writing --------------------------------------------------------------

def _infer(value) -> ArrowType:
    """The Arrow type pyarrow infers for one Python or numpy value."""
    if value is None:
        return ArrowType("null")
    if isinstance(value, (bool, np.bool_)):
        return ArrowType("bool")
    if isinstance(value, (int, np.integer)):
        return (_VALUE_DTYPES[np.dtype(type(value)).name] if isinstance(value, np.integer)
                else ArrowType("int", 64))
    if isinstance(value, (float, np.floating)):
        return (_VALUE_DTYPES[np.dtype(type(value)).name] if isinstance(value, np.floating)
                else ArrowType("float", 64))
    if isinstance(value, str):
        return ArrowType("utf8")
    if isinstance(value, (bytes, bytearray)):
        return ArrowType("binary")
    if isinstance(value, dict):
        return ArrowType("struct", children=tuple((k, _infer(v)) for k, v in value.items()))
    if isinstance(value, np.ndarray):
        if value.ndim == 0:
            return _infer(value[()])
        t = _VALUE_DTYPES.get("bool" if value.dtype == np.bool_ else value.dtype.name)
        if t is None:
            t = _unify_all(_infer(v) for v in value.reshape(-1)) if value.size else \
                ArrowType("null")
        for _ in range(value.ndim):
            t = _list_of(t)
        return t
    if isinstance(value, (list, tuple)):
        return _list_of(_unify_all(_infer(v) for v in value))
    raise TypeError(f"cannot store a {type(value).__name__} in a dataset")


def _unify(a: ArrowType, b: ArrowType) -> ArrowType:
    if a == b or b.kind == "null":
        return a
    if a.kind == "null":
        return b
    if {a.kind, b.kind} <= {"int", "float"}:
        return ArrowType("float", 64)
    if a.kind == b.kind == "list":
        return _list_of(_unify(a.item, b.item))
    if a.kind == b.kind == "struct":
        children = dict(a.children)
        for name, t in b.children:
            children[name] = _unify(children[name], t) if name in children else t
        return ArrowType("struct", children=tuple(children.items()))
    raise TypeError(f"cannot store {a!r} and {b!r} in one column")


def _unify_all(types: Iterable[ArrowType]) -> ArrowType:
    out = ArrowType("null")
    for t in types:
        out = _unify(out, t)
    return out


class _BodyWriter:
    """Collects one record batch's field nodes and buffers."""

    def __init__(self):
        self.nodes, self.buffers, self.body = [], [], bytearray()

    def buffer(self, data: bytes):
        self.buffers.append((len(self.body), len(data)))
        self.body += data
        self.body += b"\0" * (-len(self.body) % 8)

    def column(self, t: ArrowType, values: list):
        n = len(values)
        valid = np.fromiter((v is not None for v in values), bool, count=n)
        nulls = int(n - valid.sum())
        self.nodes.append((n, n if t.kind == "null" else nulls))
        if t.kind == "null":
            return
        self.buffer(np.packbits(valid, bitorder="little").tobytes() if nulls else b"")
        present = [v for v in values if v is not None]
        if t.kind == "bool":
            bits = np.zeros(n, bool)
            bits[valid] = np.asarray(present, bool)
            self.buffer(np.packbits(bits, bitorder="little").tobytes())
        elif t.kind in ("int", "float"):
            arr = np.zeros(n, t.numpy_dtype)
            if present:
                arr[valid] = np.asarray(present).astype(t.numpy_dtype)
            self.buffer(arr.tobytes())
        elif t.kind == "struct":
            for name, c in t.children:
                self.column(c, [v.get(name) if v is not None else None for v in values])
        else:
            wide = t.kind.startswith("large_")
            if t.kind in ("utf8", "large_utf8", "binary", "large_binary"):
                items = [v.encode("utf-8") if isinstance(v, str) else bytes(v) for v in present]
                sizes = [len(x) for x in items]
            else:
                items = present
                sizes = [len(v) for v in present]
            lengths = np.zeros(n, np.int64)
            lengths[valid] = sizes
            offsets = np.concatenate([[0], np.cumsum(lengths)])
            self.buffer(offsets.astype(np.int64 if wide else np.int32).tobytes())
            if t.kind in ("list", "large_list"):
                self._children(t.item, items)
            else:
                self.buffer(b"".join(items))

    def _children(self, item: ArrowType, lists: list):
        """The child column of a list column: numbers of numpy arrays in
        one concatenation, anything else element by element."""
        if item.kind in ("int", "float") and lists:
            parts = [np.asarray(v) for v in lists]
            if all(p.ndim == 1 and p.dtype != object for p in parts):
                flat = np.concatenate(parts).astype(item.numpy_dtype)
                self.nodes.append((len(flat), 0))
                self.buffer(b"")
                self.buffer(flat.tobytes())
                return
        self.column(item, [x for v in lists for x in v])


def _column_names(rows: List[dict]) -> List[str]:
    names: List[str] = []
    for row in rows:
        names += [k for k in row if k not in names]
    return names


def infer_features(rows: List[dict]) -> dict:
    """The features (dataset_info.json form) that `save_to_disk` infers for
    these rows' columns, as `datasets` infers them from the same values."""
    return {name: type_to_features(_unify_all(_infer(row.get(name)) for row in rows))
            for name in _column_names(rows)}


def _rows_of(data) -> List[dict]:
    if isinstance(data, dict):
        names = list(data)
        n = len(data[names[0]]) if names else 0
        return [{k: data[k][i] for k in names} for i in range(n)]
    return list(data)


def save_dataset_dict_json(path: str, splits: List[str]):
    """`path/dataset_dict.json`, which makes the split directories under
    `path` (each written by `save_to_disk`) one saved DatasetDict."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "dataset_dict.json"), "w") as f:
        json.dump({"splits": splits}, f)


def save_to_disk(data, path: str, features: Optional[dict] = None, num_shards: int = 1,
                 writer_batch_size: int = 1000):
    """Write `data` (a list of row dicts, a dict of equal-length columns, or
    a `Dataset`) to `path` as `datasets.Dataset.save_to_disk` does:
    `num_shards` contiguous shards of `writer_batch_size`-row record
    batches. Column types follow `features` (the dataset_info.json form)
    where given, then a `Dataset`'s own, else what pyarrow infers from the
    values: Python int/float/str/bytes/bool as int64/float64/string/binary/
    bool, numpy scalars and arrays at their dtype, lists as list, dicts as
    struct, None as null. A DatasetDict is each split saved under `path`
    by this function, then `save_dataset_dict_json(path, splits)`."""
    if isinstance(data, Dataset):
        features = {**data.features, **(features or {})}
    rows = _rows_of(data)
    features = features or {}
    names = list(features) + [k for k in _column_names(rows) if k not in features]
    types = [features_to_type(features[name]) if name in features
             else _unify_all(_infer(row.get(name)) for row in rows) for name in names]
    feats = {name: type_to_features(t) for name, t in zip(names, types)}
    schema = _T((1, "tables", [_field_table(n, t) for n, t in zip(names, types)]),
                (2, "tables", [_T((0, "str", "huggingface"),
                                  (1, "str", json.dumps({"info": {"features": feats}})))]))
    os.makedirs(path, exist_ok=True)
    n, k = len(rows), max(1, num_shards)
    files, start = [], 0
    for s in range(k):
        stop = start + n // k + (1 if s < n % k else 0)
        fname = f"data-{s:05d}-of-{k:05d}.arrow"
        with open(os.path.join(path, fname), "wb") as f:
            f.write(_message(_SCHEMA, schema, 0))
            for b in range(start, stop, max(1, writer_batch_size)):
                batch = rows[b:min(stop, b + writer_batch_size)]
                w = _BodyWriter()
                for name, t in zip(names, types):
                    w.column(t, [row.get(name) for row in batch])
                header = _T((0, "q", len(batch)),
                            (1, "structs", (len(w.nodes), b"".join(
                                struct.pack("<qq", *x) for x in w.nodes))),
                            (2, "structs", (len(w.buffers), b"".join(
                                struct.pack("<qq", *x) for x in w.buffers))))
                f.write(_message(_RECORD_BATCH, header, len(w.body)))
                f.write(w.body)
            f.write(CONTINUATION + b"\0\0\0\0")
        files.append({"filename": fname})
        start = stop
    state = {"_data_files": files, "_fingerprint": uuid.uuid4().hex[:16],
             "_format_columns": None, "_format_kwargs": {}, "_format_type": None,
             "_output_all_columns": False, "_split": None}
    info = {"citation": "", "description": "", "features": feats, "homepage": "", "license": ""}
    for fname, obj in (("state.json", state), ("dataset_info.json", info)):
        with open(os.path.join(path, fname), "w") as f:
            json.dump(obj, f, indent=2)

