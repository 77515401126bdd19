"""The Arrow IPC stream format, written by hand over numpy (the JAX
package reads and writes it through pyarrow; the port has no pyarrow).

A stream is a Schema message, then DictionaryBatch messages (a
dictionary column's values, once before the first batch that uses
them), then RecordBatch messages, then the end-of-stream marker. Each
message is encapsulated: the `0xFFFFFFFF` continuation, the i32 length
of the flatbuffer header (padded so the body starts 8-aligned), the
header (`Message.fbs`, built with `utils/flatbuf.py`), then the body,
its buffers each padded to 8 bytes. Arrow Flight carries the same
header and body in `FlightData.data_header` / `data_body` instead
(`servers/flight_proto.py`); `encode_messages` and `StreamReader` are
the framing-free halves both share.

Tables are the port's column tables (`datasource.TextTable` of
`TextColumn`s) with the schema's `custom_metadata` in
`TextTable.metadata` (bytes to bytes). The column types, under
pyarrow's names: null; bool; int8-int64 and uint8-uint64; float and
double; string and large_string (utf8, large_utf8); binary;
timestamp[s|ms|us|ns], with a time zone as `timestamp[ms, tz=UTC]`;
date32 (days). A dictionary column (`dictionary` set, `values` int32
codes, -1 for NULL) is written with int32 indices over its value type;
int8-int64 indices are read. Validity bitmaps are written only for a
column that holds a NULL, as pyarrow writes them.

A compressed body, a non-little-endian stream or a type outside this
list is refused with `IpcError`: never read wrongly.
"""

from __future__ import annotations

import re
import struct
from typing import Iterator, Optional

import numpy as np

from greptimedb_tpu_torch.datasource import (
    NUMPY_OF,
    DataSourceError,
    TextColumn,
    TextTable,
)
from greptimedb_tpu_torch.utils import flatbuf
from greptimedb_tpu_torch.utils.flatbuf import Builder, Table


class IpcError(DataSourceError):
    """An Arrow IPC stream this reader refuses: malformed, compressed,
    big-endian, or holding a type outside the port's list."""


CONTINUATION = b"\xff\xff\xff\xff"
EOS = CONTINUATION + b"\0\0\0\0"
_V5 = 4  # MetadataVersion.V5

# MessageHeader union
_H_SCHEMA, _H_DICT, _H_BATCH = 1, 2, 3
# Type union
_T_NULL, _T_INT, _T_FLOAT, _T_BINARY, _T_UTF8, _T_BOOL = 1, 2, 3, 4, 5, 6
_T_DATE, _T_TIMESTAMP, _T_LARGE_BINARY, _T_LARGE_UTF8 = 8, 10, 19, 20
_UNIT = ("s", "ms", "us", "ns")
_TS = re.compile(r"timestamp\[(s|ms|us|ns)(?:, tz=(.+))?\]\Z")
_INTS = {"int8": (8, True), "int16": (16, True), "int32": (32, True),
         "int64": (64, True), "uint8": (8, False), "uint16": (16, False),
         "uint32": (32, False), "uint64": (64, False)}
_INT_NAME = {v: k for k, v in _INTS.items()}
_VARLEN = {"string": (_T_UTF8, np.int32), "large_string": (_T_LARGE_UTF8,
                                                           np.int64),
           "binary": (_T_BINARY, np.int32),
           "large_binary": (_T_LARGE_BINARY, np.int64)}
_VARLEN_NAME = {tid: name for name, (tid, _) in _VARLEN.items()}
_NODE = np.dtype([("length", "<i8"), ("null_count", "<i8")])
_BUFFER = np.dtype([("offset", "<i8"), ("length", "<i8")])


def _pad8(n: int) -> int:
    return (-n) % 8


# ---- schema -------------------------------------------------------------------


class Field:
    """One schema field: name, type (pyarrow's name; a dictionary
    field's value type), dictionary id and index bit width (None for a
    plain field)."""

    __slots__ = ("name", "type", "dict_id", "index_bits", "index_signed")

    def __init__(self, name: str, type: str, dict_id: Optional[int] = None,
                 index_bits: int = 32, index_signed: bool = True):
        self.name = name
        self.type = type
        self.dict_id = dict_id
        self.index_bits = index_bits
        self.index_signed = index_signed


def _type_table(b: Builder, t: str) -> tuple[int, flatbuf.Ref]:
    if t == "null":
        return _T_NULL, b.table([])
    if t == "bool":
        return _T_BOOL, b.table([])
    if t in _INTS:
        bits, signed = _INTS[t]
        return _T_INT, b.table([(0, "i32", bits), (1, "bool", signed)])
    if t in ("float", "double"):
        return _T_FLOAT, b.table([(0, "i16", 1 if t == "float" else 2)])
    if t in _VARLEN:
        return _VARLEN[t][0], b.table([])
    if t == "date32":
        return _T_DATE, b.table([(0, "i16", 0)])
    m = _TS.match(t)
    if m:
        tz = b.string(m.group(2)) if m.group(2) else None
        return _T_TIMESTAMP, b.table([(0, "i16", _UNIT.index(m.group(1))),
                                      (1, "ref", tz)])
    raise IpcError(f"no Arrow IPC type for column type {t!r}")


def _read_type(tid: int, tt: Optional[Table]) -> str:
    if tid == _T_NULL:
        return "null"
    if tid == _T_BOOL:
        return "bool"
    if tt is None:
        raise IpcError(f"type {tid} without its table")
    if tid == _T_INT:
        key = (tt.scalar(0, "i32"), tt.scalar(1, "bool", False))
        if key not in _INT_NAME:
            raise IpcError(f"unsupported Int type {key}")
        return _INT_NAME[key]
    if tid == _T_FLOAT:
        precision = tt.scalar(0, "i16")
        if precision not in (1, 2):
            raise IpcError("half floats are not supported")
        return "float" if precision == 1 else "double"
    if tid in _VARLEN_NAME:
        return _VARLEN_NAME[tid]
    if tid == _T_DATE:
        if tt.scalar(0, "i16", 1) != 0:
            raise IpcError("date64 is not supported")
        return "date32"
    if tid == _T_TIMESTAMP:
        unit = tt.scalar(0, "i16")
        if not 0 <= unit < 4:
            raise IpcError(f"bad timestamp unit {unit}")
        tz = tt.string(1)
        return (f"timestamp[{_UNIT[unit]}, tz={tz.decode()}]" if tz
                else f"timestamp[{_UNIT[unit]}]")
    raise IpcError(f"unsupported Arrow type id {tid}")


def _key_values(b: Builder, meta: Optional[dict]) -> Optional[flatbuf.Ref]:
    if not meta:
        return None
    kvs = [b.table([(0, "ref", b.string(k)), (1, "ref", b.string(v))])
           for k, v in meta.items()]
    return b.vector_of_refs(kvs)


def _message(b: Builder, htype: int, header: flatbuf.Ref,
             body_len: int) -> bytes:
    msg = b.table([(0, "i16", _V5), (1, "u8", htype), (2, "ref", header),
                   (3, "i64", body_len)])
    return b.finish(msg)


def schema_fields(table: TextTable) -> list[Field]:
    """The fields a table is written with; dictionary ids in order."""
    out, n_dict = [], 0
    for name in table.names:
        col = table.column(name)
        if col.dictionary is not None:
            out.append(Field(name, col.type, n_dict))
            n_dict += 1
        else:
            out.append(Field(name, col.type))
    return out


def schema_message(fields: list[Field], metadata: Optional[dict]) -> bytes:
    b = Builder()
    frefs = []
    for f in fields:
        tid, tref = _type_table(b, f.type)
        name = b.string(f.name)
        denc = None
        if f.dict_id is not None:
            idx = b.table([(0, "i32", f.index_bits),
                           (1, "bool", f.index_signed)])
            denc = b.table([(0, "i64", f.dict_id), (1, "ref", idx),
                            (2, "bool", False)])
        children = b.vector_of_refs([])
        frefs.append(b.table([(0, "ref", name), (1, "bool", True),
                              (2, "u8", tid), (3, "ref", tref),
                              (4, "ref", denc), (5, "ref", children)]))
    fvec = b.vector_of_refs(frefs)
    meta = _key_values(b, metadata)
    schema = b.table([(0, "i16", 0), (1, "ref", fvec), (2, "ref", meta)])
    return _message(b, _H_SCHEMA, schema, 0)


def read_schema(header: Table) -> tuple[list[Field], dict]:
    if header.scalar(0, "i16") != 0:
        raise IpcError("big-endian Arrow streams are not supported")
    fields = []
    for ft in header.tables(1):
        name = (ft.string(0) or b"").decode()
        tid = ft.scalar(2, "u8")
        t = _read_type(tid, ft.table(3))
        if ft.vector(5)[1]:
            raise IpcError(f"nested field {name!r} is not supported")
        denc = ft.table(4)
        if denc is None:
            fields.append(Field(name, t))
            continue
        idx = denc.table(1)
        bits = idx.scalar(0, "i32") if idx is not None else 32
        signed = idx.scalar(1, "bool", False) if idx is not None else True
        if (bits, signed) not in _INT_NAME:
            raise IpcError(f"bad dictionary index type {(bits, signed)}")
        fields.append(Field(name, t, denc.scalar(0, "i64"), bits, signed))
    meta = {}
    for kv in header.tables(2):
        meta[kv.string(0) or b""] = kv.string(1) or b""
    return fields, meta


# ---- record batches ----------------------------------------------------------


def _validity(valid: Optional[np.ndarray], n: int) -> tuple[bytes, int]:
    if valid is None:
        return b"", 0
    nulls = int(n - np.count_nonzero(valid))
    if not nulls:
        return b"", 0
    return np.packbits(valid, bitorder="little").tobytes(), nulls


def _varlen_buffers(vals: np.ndarray, binary: bool,
                    off_dtype) -> tuple[bytes, bytes]:
    items = vals.tolist()
    if binary:
        raws = [b"" if v is None else bytes(v) for v in items]
    else:
        raws = [b"" if v is None else v.encode() for v in items]
    lens = np.fromiter(map(len, raws), np.int64, len(raws))
    offsets = np.zeros(len(raws) + 1, dtype=np.int64)
    np.cumsum(lens, out=offsets[1:])
    if off_dtype == np.int32 and offsets[-1] > np.iinfo(np.int32).max:
        raise IpcError("a string column past 2 GiB needs large_string")
    return offsets.astype(off_dtype).tobytes(), b"".join(raws)


def _column_buffers(t: str, values: np.ndarray,
                    valid: Optional[np.ndarray]) -> tuple[list, int]:
    n = len(values)
    vbuf, nulls = _validity(valid, n)
    if t == "null":
        return [], n
    if t == "bool":
        return [vbuf, np.packbits(values.astype(bool),
                                  bitorder="little").tobytes()], nulls
    if t in _VARLEN:
        offs, data = _varlen_buffers(values, "binary" in t, _VARLEN[t][1])
        return [vbuf, offs, data], nulls
    if t == "date32":
        return [vbuf, values.astype("<i4").tobytes()], nulls
    if _TS.match(t):
        return [vbuf, values.astype("<i8").tobytes()], nulls
    if t in NUMPY_OF:
        return [vbuf, values.astype(np.dtype(NUMPY_OF[t]).newbyteorder("<"),
                                    copy=False).tobytes()], nulls
    raise IpcError(f"no Arrow IPC type for column type {t!r}")


def _batch_body(columns: list) -> tuple[np.ndarray, np.ndarray, bytes]:
    """(nodes, buffers, body) of `columns`: (type, values, valid)."""
    nodes, bufs, parts = [], [], []
    pos = 0
    for t, values, valid in columns:
        buffers, nulls = _column_buffers(t, values, valid)
        nodes.append((len(values), nulls))
        for raw in buffers:
            bufs.append((pos, len(raw)))
            pad = _pad8(len(raw))
            parts.append(raw)
            if pad:
                parts.append(b"\0" * pad)
            pos += len(raw) + pad
    return (np.array(nodes, dtype=_NODE), np.array(bufs, dtype=_BUFFER),
            b"".join(parts))


def _batch_table(b: Builder, n: int, nodes: np.ndarray,
                 bufs: np.ndarray) -> flatbuf.Ref:
    nv = b.vector_of_structs(nodes.tobytes(), len(nodes))
    bv = b.vector_of_structs(bufs.tobytes(), len(bufs))
    return b.table([(0, "i64", n), (1, "ref", nv), (2, "ref", bv)])


def batch_message(n: int, columns: list) -> tuple[bytes, bytes]:
    nodes, bufs, body = _batch_body(columns)
    b = Builder()
    return _message(b, _H_BATCH, _batch_table(b, n, nodes, bufs),
                    len(body)), body


def dictionary_message(dict_id: int, t: str,
                       values: np.ndarray) -> tuple[bytes, bytes]:
    nodes, bufs, body = _batch_body([(t, values, _not_none(values))])
    b = Builder()
    data = _batch_table(b, len(values), nodes, bufs)
    d = b.table([(0, "i64", dict_id), (1, "ref", data), (2, "bool", False)])
    return _message(b, _H_DICT, d, len(body)), body


def _not_none(values: np.ndarray) -> Optional[np.ndarray]:
    if values.dtype != object:
        return None
    valid = np.fromiter((v is not None for v in values.tolist()), bool,
                        len(values))
    return None if valid.all() else valid


#: rows a record batch carries at most: a 1.44 M-row region scan goes
#: out as bounded messages, never as one of 150 MB
BATCH_ROWS = 1 << 16


def encode_messages(table: TextTable,
                    batch_rows: int = BATCH_ROWS) -> Iterator[tuple[bytes,
                                                                    bytes]]:
    """(header, body) of each message of `table`: the schema, each
    dictionary once, then record batches of at most `batch_rows` rows
    (one for an empty table)."""
    fields = schema_fields(table)
    yield schema_message(fields, table.metadata), b""
    cols = [table.column(f.name) for f in fields]
    for f, col in zip(fields, cols):
        if f.dict_id is not None:
            yield dictionary_message(f.dict_id, col.type, col.dictionary)
    n = table.num_rows
    step = max(1, batch_rows)
    for r0 in range(0, max(n, 1), step):
        r1 = min(n, r0 + step)
        parts = []
        for f, col in zip(fields, cols):
            valid = None if col.valid is None else col.valid[r0:r1]
            if f.dict_id is not None:
                codes = col.values[r0:r1]
                valid = codes >= 0 if valid is None else valid
                parts.append(("int32", np.maximum(codes, 0), valid))
            else:
                parts.append((col.type, col.values[r0:r1], valid))
        yield batch_message(r1 - r0, parts)


def encapsulate(header: bytes) -> bytes:
    """A message's header framed: the continuation, the padded length,
    the header and its padding (the body follows)."""
    pad = _pad8(len(header))
    return CONTINUATION + struct.pack("<i", len(header) + pad) + header \
        + b"\0" * pad


def write_stream(table: TextTable, batch_rows: int = BATCH_ROWS) -> bytes:
    out = []
    for header, body in encode_messages(table, batch_rows):
        out += [encapsulate(header), body]
    out.append(EOS)
    return b"".join(out)


# ---- reading -----------------------------------------------------------------


class _Body:
    """A message body and its buffer list, read in order."""

    def __init__(self, body, nodes: np.ndarray, bufs: np.ndarray):
        self.body = memoryview(body)
        self.nodes = nodes
        self.bufs = bufs
        self.ni = 0
        self.bi = 0

    def node(self) -> tuple[int, int]:
        if self.ni >= len(self.nodes):
            raise IpcError("record batch has fewer nodes than fields")
        n = self.nodes[self.ni]
        self.ni += 1
        return int(n["length"]), int(n["null_count"])

    def buffer(self) -> memoryview:
        if self.bi >= len(self.bufs):
            raise IpcError("record batch has fewer buffers than its types")
        off, ln = int(self.bufs[self.bi]["offset"]), \
            int(self.bufs[self.bi]["length"])
        self.bi += 1
        if off < 0 or ln < 0 or off + ln > len(self.body):
            raise IpcError("buffer outside the message body")
        return self.body[off:off + ln]


def _fixed(buf: memoryview, dtype, n: int) -> np.ndarray:
    dtype = np.dtype(dtype).newbyteorder("<")
    if len(buf) < n * dtype.itemsize:
        raise IpcError("buffer shorter than its column")
    return np.frombuffer(buf, dtype=dtype, count=n).astype(
        dtype.newbyteorder("="))


def _bits(buf: memoryview, n: int) -> np.ndarray:
    if len(buf) * 8 < n:
        raise IpcError("bitmap shorter than its column")
    return np.unpackbits(np.frombuffer(buf, dtype=np.uint8),
                         count=n, bitorder="little").astype(bool)


def _read_column(t: str, body: _Body) -> tuple[np.ndarray,
                                               Optional[np.ndarray]]:
    n, nulls = body.node()
    if t == "null":
        return np.zeros(n, dtype=np.int64), np.zeros(n, dtype=bool)
    vbuf = body.buffer()
    valid = _bits(vbuf, n) if nulls and len(vbuf) else None
    if t == "bool":
        return _bits(body.buffer(), n), valid
    if t in _VARLEN:
        offs = _fixed(body.buffer(), _VARLEN[t][1], n + 1).astype(np.int64)
        data = body.buffer()
        if n and (offs[0] < 0 or offs[-1] > len(data)
                  or (np.diff(offs) < 0).any()):
            raise IpcError("string offsets outside their data")
        raw = bytes(data)
        bounds = offs.tolist()
        if "binary" in t:
            vals = [raw[a:b] for a, b in zip(bounds, bounds[1:])]
        else:
            vals = [raw[a:b].decode() for a, b in zip(bounds, bounds[1:])]
        out = np.empty(n, dtype=object)
        out[:] = vals
        return out, valid
    if t == "date32":
        return _fixed(body.buffer(), np.int32, n), valid
    if _TS.match(t):
        return _fixed(body.buffer(), np.int64, n), valid
    return _fixed(body.buffer(), NUMPY_OF[t], n), valid


def _read_batch(bt: Table, body, types: list) -> tuple[int, list]:
    if bt.table(3) is not None:
        raise IpcError("compressed Arrow IPC bodies are not supported")
    n = bt.scalar(0, "i64")
    rb = _Body(body, bt.structs(1, _NODE), bt.structs(2, _BUFFER))
    return n, [_read_column(t, rb) for t in types]


class StreamReader:
    """Folds messages (header, body) into a TextTable: the schema first,
    dictionaries (a replacement or a delta as they come), then batches."""

    def __init__(self):
        self.fields: Optional[list[Field]] = None
        self.metadata: dict = {}
        self._dicts: dict = {}
        self._batches: list = []

    def add(self, header, body=b"") -> None:
        try:
            msg = Table.root(header)
            if msg.scalar(0, "i16") < _V5 - 1:
                raise IpcError("Arrow IPC metadata before V4 is not "
                               "supported")
            htype = msg.scalar(1, "u8")
            ht = msg.table(2)
            if ht is None:
                raise IpcError("message without a header")
            if htype == _H_SCHEMA:
                self.fields, self.metadata = read_schema(ht)
            elif self.fields is None:
                raise IpcError("batch before the schema")
            elif htype == _H_DICT:
                self._add_dictionary(ht, body)
            elif htype == _H_BATCH:
                self._add_batch(ht, body)
            else:
                raise IpcError(f"unsupported message type {htype}")
        except flatbuf.FlatbufError as e:
            raise IpcError(f"malformed Arrow IPC header: {e}") from e

    def _add_dictionary(self, ht: Table, body) -> None:
        did = ht.scalar(0, "i64")
        field = next((f for f in self.fields if f.dict_id == did), None)
        if field is None:
            raise IpcError(f"dictionary {did} has no field")
        data = ht.table(1)
        if data is None:
            raise IpcError("dictionary batch without data")
        _, [(vals, valid)] = _read_batch(data, body, [field.type])
        if valid is not None:
            vals = np.where(valid, vals, None)
        if ht.scalar(2, "bool", False) and did in self._dicts:
            vals = np.concatenate([self._dicts[did], vals])
        self._dicts[did] = vals

    def _add_batch(self, ht: Table, body) -> None:
        types = [f.type if f.dict_id is None else
                 _INT_NAME[(f.index_bits, f.index_signed)]
                 for f in self.fields]
        n, cols = _read_batch(ht, body, types)
        out = []
        for f, (vals, valid) in zip(self.fields, cols):
            if f.dict_id is None:
                out.append(TextColumn(vals, valid, f.type))
                continue
            if f.dict_id not in self._dicts:
                raise IpcError(f"batch before dictionary {f.dict_id}")
            codes = vals.astype(np.int32)
            if valid is not None:
                codes = np.where(valid, codes, -1).astype(np.int32)
            d = self._dicts[f.dict_id]
            if len(codes) and codes.max(initial=-1) >= len(d):
                raise IpcError("dictionary index past its dictionary")
            out.append(TextColumn(codes, valid, f.type, d))
        self._batches.append((n, out))

    def table(self) -> TextTable:
        if self.fields is None:
            raise IpcError("stream without a schema")
        names = [f.name for f in self.fields]
        n = sum(b[0] for b in self._batches)
        cols = {}
        for i, f in enumerate(self.fields):
            parts = [b[1][i] for b in self._batches]
            cols[f.name] = _concat(parts, f)
        return TextTable(names, cols, n, self.metadata)


def _concat(parts: list, f: Field) -> TextColumn:
    if not parts:
        if f.dict_id is not None:
            return TextColumn(np.zeros(0, dtype=np.int32), None, f.type,
                              np.zeros(0, dtype=object))
        return TextColumn(_empty(f.type), None, f.type)
    if len(parts) == 1:
        return parts[0]
    valid = None
    if any(p.valid is not None for p in parts):
        valid = np.concatenate([np.ones(len(p), bool) if p.valid is None
                                else p.valid for p in parts])
    if f.dict_id is None:
        return TextColumn(np.concatenate([p.values for p in parts]), valid,
                          f.type)
    first = parts[0].dictionary
    if all(p.dictionary is first for p in parts):
        return TextColumn(np.concatenate([p.values for p in parts]), valid,
                          f.type, first)
    # replaced dictionaries: codes into one merged dictionary
    merged: dict = {}
    codes = []
    for p in parts:
        remap = np.fromiter((merged.setdefault(v, len(merged))
                             for v in p.dictionary.tolist()), np.int32,
                            len(p.dictionary))
        codes.append(np.where(p.values >= 0,
                              remap[np.maximum(p.values, 0)]
                              if len(remap) else -1, -1).astype(np.int32))
    return TextColumn(np.concatenate(codes), valid, f.type,
                      np.asarray(list(merged), dtype=object))


def _empty(t: str) -> np.ndarray:
    if t in _VARLEN:
        return np.zeros(0, dtype=object)
    if t == "date32":
        return np.zeros(0, dtype=np.int32)
    if t == "null" or _TS.match(t):
        return np.zeros(0, dtype=np.int64)
    return np.zeros(0, dtype=NUMPY_OF.get(t, np.int64))


def read_stream(data) -> TextTable:
    """A TextTable from the bytes of an Arrow IPC stream."""
    buf = memoryview(data)
    pos = 0
    r = StreamReader()
    while pos + 4 <= len(buf):
        (ln,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        if ln == -1:  # the continuation marker, then the length
            if pos + 4 > len(buf):
                raise IpcError("stream cut after a continuation marker")
            (ln,) = struct.unpack_from("<i", buf, pos)
            pos += 4
        if ln == 0:
            break  # end of stream
        if ln < 0 or pos + ln > len(buf):
            raise IpcError("message length runs past the stream")
        header = buf[pos:pos + ln]
        pos += ln
        try:
            body_len = Table.root(header).scalar(3, "i64")
        except flatbuf.FlatbufError as e:
            raise IpcError(f"malformed Arrow IPC header: {e}") from e
        if body_len < 0 or pos + body_len > len(buf):
            raise IpcError("message body runs past the stream")
        r.add(header, buf[pos:pos + body_len])
        pos += body_len
    return r.table()
