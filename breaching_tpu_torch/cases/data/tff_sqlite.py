"""TFF-format sqlite client data (stackoverflow / shakespeare), a copy of
``breaching_tpu/cases/data/tff_sqlite.py`` (pure Python: sqlite3 and a tf.Example codec).

The reference (breaching/cases/data/datasets_text.py:262-392) downloads
`stackoverflow.sqlite.lzma` / `shakespeare.sqlite.lzma` from the TFF public
bucket and parses each row's serialized `tf.Example` with tensorflow. This module
needs neither the network nor tensorflow; it provides:

- a minimal pure-python tf.Example wire-format codec (decode + encode);
- the sqlite client-data reader with the TFF schema
  `client_metadata(client_id, split_name, num_examples)` and
  `examples(split_name, client_id, serialized_example_proto)`;
- `create_tff_database` to produce such databases locally (tests, converters).

A decompressed `<name>.sqlite` in `cfg.data.path` gives the text pipeline the
natural per-client federated partition.
"""

from __future__ import annotations

import os
import sqlite3
import struct

# text payload field per corpus (reference datasets_text.py:352, 385)
TFF_TEXT_FIELDS = {"stackoverflow": "tokens", "shakespeare": "snippets"}


def tff_split_name(name: str, split: str) -> str:
    """Map framework split names onto the TFF database split names
    (reference datasets_text.py:328-333, 366-371)."""
    split = {"training": "train"}.get(split, split)
    if name == "stackoverflow":
        mapping = {"train": "train", "validation": "heldout", "test": "test"}
    else:  # shakespeare has no heldout split
        mapping = {"train": "train", "validation": "test", "test": "test"}
    if split not in mapping:
        raise ValueError(f"Split {split} does not exist in the {name} database.")
    return mapping[split]


# ---------------------------------------------------------------- wire format
# tf.Example proto schema (tensorflow/core/example/example.proto):
#   Example   = { 1: Features }
#   Features  = { 1: repeated map entry { 1: key (string), 2: Feature } }
#   Feature   = { 1: BytesList, 2: FloatList, 3: Int64List }
#   BytesList = { 1: repeated bytes }; FloatList/Int64List packed repeated.


def _read_varint(buf: bytes, i: int):
    result = shift = 0
    while True:
        byte = buf[i]
        i += 1
        result |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return result, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's wire data."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 0x7
        if wire == 0:  # varint
            value, i = _read_varint(buf, i)
        elif wire == 1:  # fixed64
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:  # length-delimited
            length, i = _read_varint(buf, i)
            value, i = buf[i:i + length], i + length
        elif wire == 5:  # fixed32
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"Unsupported protobuf wire type {wire}.")
        yield field, wire, value


def _to_int64(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


def _parse_value_list(buf: bytes, kind: int):
    """Parse BytesList/FloatList/Int64List submessages (kind = Feature field no)."""
    values = []
    for field, wire, value in _iter_fields(buf):
        if field != 1:
            continue
        if kind == 1:  # BytesList
            values.append(value)
        elif kind == 2:  # FloatList: packed (wire 2) or unpacked fixed32
            if wire == 2:
                values.extend(struct.unpack(f"<{len(value) // 4}f", value))
            else:
                values.append(struct.unpack("<f", value)[0])
        else:  # Int64List: packed (wire 2) or unpacked varints
            if wire == 2:
                i = 0
                while i < len(value):
                    v, i = _read_varint(value, i)
                    values.append(_to_int64(v))
            else:
                values.append(_to_int64(value))
    return values


def parse_tf_example(buf: bytes) -> dict:
    """Decode a serialized tf.Example into {name: list of bytes/float/int}."""
    features = {}
    for field, _, value in _iter_fields(buf):
        if field != 1:  # Example.features
            continue
        for ffield, _, entry in _iter_fields(value):
            if ffield != 1:  # Features.feature map entry
                continue
            key, payload = None, []
            for efield, _, evalue in _iter_fields(entry):
                if efield == 1:
                    key = evalue.decode("utf-8")
                elif efield == 2:  # Feature
                    for kind, _, lst in _iter_fields(evalue):
                        payload = _parse_value_list(lst, kind)
            if key is not None:
                features[key] = payload
    return features


def _varint(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        out.append(byte | (0x80 if value else 0))
        if not value:
            return bytes(out)


def _ld(field: int, payload: bytes) -> bytes:
    """Length-delimited field."""
    return _varint(field << 3 | 2) + _varint(len(payload)) + payload


def encode_tf_example(features: dict) -> bytes:
    """Encode {name: list of bytes/str/int/float} as a serialized tf.Example."""
    entries = b""
    for key, values in features.items():
        if not isinstance(values, (list, tuple)):
            values = [values]
        if values and isinstance(values[0], float):
            lst = _ld(2, _ld(1, struct.pack(f"<{len(values)}f", *values)))
        elif values and isinstance(values[0], int):
            packed = b"".join(_varint(v & ((1 << 64) - 1)) for v in values)
            lst = _ld(3, _ld(1, packed))
        else:
            raw = [v.encode("utf-8") if isinstance(v, str) else v for v in values]
            lst = _ld(1, b"".join(_ld(1, v) for v in raw))
        entries += _ld(1, _ld(1, key.encode("utf-8")) + _ld(2, lst))
    return _ld(1, entries)


# ------------------------------------------------------------------- database


def client_ids(db_path: str, split_name: str | None = None):
    """Ordered distinct client ids (reference datasets_text.py:297-317 iterates
    the DISTINCT result in insertion order; ORDER BY rowid makes that explicit)."""
    with sqlite3.connect(db_path) as conn:
        query = "SELECT DISTINCT client_id FROM client_metadata"
        args = ()
        if split_name is not None:
            query += " WHERE split_name = ?"
            args = (split_name,)
        return [row[0] for row in conn.execute(query + " ORDER BY rowid;", args)]


def load_client_examples(db_path: str, client_id: str, split_name: str):
    """All decoded tf.Examples of one client in one split."""
    with sqlite3.connect(db_path) as conn:
        rows = conn.execute(
            "SELECT serialized_example_proto FROM examples "
            "WHERE client_id = ? AND split_name = ? ORDER BY rowid;",
            (client_id, split_name))
        return [parse_tf_example(row[0]) for row in rows]


def load_client_texts(db_path: str, user_idx: int, split_name: str, field: str):
    """The reference flow (datasets_text.py:326-361): user_idx -> client_id ->
    that client's text field, decoded to str."""
    ids = client_ids(db_path, split_name)
    if user_idx >= len(ids):
        raise ValueError(
            f"Given user idx {user_idx} larger than number of clients in database.")
    examples = load_client_examples(db_path, ids[user_idx], split_name)
    texts = []
    for example in examples:
        value = example.get(field, [])
        texts.extend(v.decode("utf-8", errors="replace") for v in value)
    return texts


def create_tff_database(db_path: str, rows):
    """Produce a TFF-schema sqlite database.

    `rows`: iterable of (client_id, split_name, features-dict) — one tf.Example
    per entry. Used by tests and by offline converters of raw corpora.
    """
    os.makedirs(os.path.dirname(os.path.abspath(db_path)), exist_ok=True)
    with sqlite3.connect(db_path) as conn:
        conn.execute("CREATE TABLE IF NOT EXISTS client_metadata ("
                     "client_id TEXT, split_name TEXT, num_examples INTEGER);")
        conn.execute("CREATE TABLE IF NOT EXISTS examples (split_name TEXT, "
                     "client_id TEXT, serialized_example_proto BLOB);")
        counts = {}
        for client_id, split_name, features in rows:
            conn.execute(
                "INSERT INTO examples VALUES (?, ?, ?);",
                (split_name, client_id, encode_tf_example(features)))
            counts[(client_id, split_name)] = counts.get((client_id, split_name), 0) + 1
        for (client_id, split_name), n in counts.items():
            conn.execute("INSERT INTO client_metadata VALUES (?, ?, ?);",
                         (client_id, split_name, n))
        conn.commit()
    return db_path
