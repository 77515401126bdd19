"""ORC, read and written by hand (the JAX package uses `pyarrow.orc`;
the port has no pyarrow). The postscript, footer and stripe footers are
protobuf messages (`utils/protowire.py`); field numbers below are
orc_proto.proto's.

Reader (`read(raw) -> TextTable`): a flat STRUCT root of BOOLEAN, BYTE,
SHORT, INT, LONG, FLOAT, DOUBLE, STRING / VARCHAR / CHAR, BINARY, DATE
and TIMESTAMP columns (anything else raises `DataSourceError`).
Encodings: byte RLE, boolean bit RLE (most significant bit first),
integer RLE v2 (short repeat, direct, patched base, delta) and v1,
IEEE floats, strings DIRECT / DIRECT_V2 and DICTIONARY / DICTIONARY_V2.
Timestamps are seconds from 2015-01-01 UTC plus nanoseconds with ORC's
trailing-zero encoding, read as timestamp[ns] (as pyarrow reads them).
Codecs: NONE, ZLIB and SNAPPY; another (ZSTD, LZ4, LZO) raises naming
it.

Writer (`write(table, compression="none") -> bytes`): ORC 0.12, one
stripe per 1 Mi rows, integers as RLE v2 DIRECT runs of 512 at one
width a stream, strings DICTIONARY_V2 (the column's dictionary), booleans
and bytes in (bit) RLE literals, PRESENT streams for columns with NULLs,
writer timezone UTC, no row index. pyarrow's ORC writer refuses
unsigned and null columns; so does this one.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from greptimedb_tpu_torch.datasource import DataSourceError, TextColumn, \
    TextTable
from greptimedb_tpu_torch.utils.protowire import (
    field_bytes,
    field_str,
    field_varint,
    iter_fields,
    read_varint,
    write_varint,
)

MAGIC = b"ORC"
#: 2015-01-01 00:00:00 UTC, ORC's timestamp epoch
EPOCH_2015 = 1_420_070_400
STRIPE_ROWS = 1 << 20
BLOCK = 1 << 18

# type kinds
BOOLEAN, BYTE, SHORT, INT, LONG, FLOAT, DOUBLE, STRING, BINARY, TIMESTAMP, \
    LIST, MAP, STRUCT, UNION, DECIMAL, DATE, VARCHAR, CHAR, \
    TIMESTAMP_INSTANT = range(19)
# stream kinds
PRESENT, DATA, LENGTH, DICTIONARY_DATA, DICTIONARY_COUNT, SECONDARY, \
    ROW_INDEX = range(7)
# column encodings
DIRECT, DICTIONARY, DIRECT_V2, DICTIONARY_V2 = range(4)
COMPRESSION = {0: "NONE", 1: "ZLIB", 2: "SNAPPY", 3: "LZO", 4: "LZ4",
               5: "ZSTD"}

_KIND_TYPE = {BOOLEAN: "bool", BYTE: "int8", SHORT: "int16", INT: "int32",
              LONG: "int64", FLOAT: "float", DOUBLE: "double",
              STRING: "string", VARCHAR: "string", CHAR: "string",
              BINARY: "binary", TIMESTAMP: "timestamp[ns]",
              TIMESTAMP_INSTANT: "timestamp[ns]", DATE: "date32"}
_TYPE_KIND = {"bool": BOOLEAN, "int8": BYTE, "int16": SHORT, "int32": INT,
              "int64": LONG, "float": FLOAT, "double": DOUBLE,
              "string": STRING, "binary": BINARY, "date32": DATE,
              "timestamp[s]": TIMESTAMP, "timestamp[ms]": TIMESTAMP,
              "timestamp[us]": TIMESTAMP, "timestamp[ns]": TIMESTAMP}
_TIME_SCALE = {"timestamp[s]": 10**9, "timestamp[ms]": 10**6,
               "timestamp[us]": 10**3, "timestamp[ns]": 1}

#: RLE v2's 5-bit width codes
_WIDTHS = list(range(1, 25)) + [26, 28, 30, 32, 40, 48, 56, 64]
_WIDTH_CODE = {w: i for i, w in enumerate(_WIDTHS)}


def _err(msg: str) -> DataSourceError:
    return DataSourceError(f"orc: {msg}")


def _closest_fixed_bits(n: int) -> int:
    for w in _WIDTHS:
        if w >= n:
            return w
    return 64


def _fields(data: bytes) -> dict:
    """{field: [values]} of one protobuf message (packed varints of a
    repeated field stay bytes)."""
    out: dict = {}
    for f, _wt, v in iter_fields(data):
        out.setdefault(f, []).append(v)
    return out


def _packed(vals: list) -> list:
    """A repeated varint field, packed or not."""
    out = []
    for v in vals:
        if isinstance(v, (bytes, bytearray, memoryview)):
            pos = 0
            while pos < len(v):
                x, pos = read_varint(v, pos)
                out.append(x)
        else:
            out.append(v)
    return out


# ---- compression ---------------------------------------------------------------


def _decompress(kind: int, data: bytes) -> bytes:
    if kind == 0:
        return data
    if kind not in (1, 2):
        raise _err(f"compression {COMPRESSION.get(kind, kind)} is not "
                   "supported by greptimedb_tpu_torch (supported: NONE, "
                   "ZLIB, SNAPPY)")
    out = []
    pos = 0
    while pos + 3 <= len(data):
        h = data[pos] | data[pos + 1] << 8 | data[pos + 2] << 16
        pos += 3
        n = h >> 1
        chunk = data[pos:pos + n]
        pos += n
        if h & 1:
            out.append(bytes(chunk))
        elif kind == 1:
            out.append(zlib.decompress(chunk, -15))
        else:
            from greptimedb_tpu_torch.utils import snappy

            out.append(snappy.decompress(bytes(chunk)))
    return b"".join(out)


def _compress(kind: int, data: bytes) -> bytes:
    if kind == 0:
        return data
    out = []
    for i in range(0, len(data), BLOCK):
        raw = data[i:i + BLOCK]
        if kind == 1:
            c = zlib.compressobj(6, zlib.DEFLATED, -15)
            comp = c.compress(raw) + c.flush()
        else:
            from greptimedb_tpu_torch.utils import snappy

            comp = snappy.compress(raw)
        if len(comp) >= len(raw):
            comp, original = raw, 1
        else:
            original = 0
        h = (len(comp) << 1) | original
        out.append(bytes([h & 0xFF, (h >> 8) & 0xFF, (h >> 16) & 0xFF]))
        out.append(comp)
    return b"".join(out)


# ---- run-length decoders -----------------------------------------------------


def byte_rle(buf, count: int) -> np.ndarray:
    out = np.empty(count, dtype=np.uint8)
    got = pos = 0
    while got < count:
        if pos >= len(buf):
            raise _err("byte RLE ends before its values")
        c = buf[pos]
        pos += 1
        if c < 128:
            n = min(c + 3, count - got)
            out[got:got + n] = buf[pos]
            pos += 1
        else:
            n = min(256 - c, count - got)
            out[got:got + n] = np.frombuffer(buf, np.uint8, n, pos)
            pos += 256 - c
        got += n
    return out


def bool_rle(buf, count: int) -> np.ndarray:
    nbytes = (count + 7) // 8
    return np.unpackbits(byte_rle(buf, nbytes))[:count].astype(bool)


def _unpack_be(buf, pos: int, width: int, count: int):
    """`count` big-endian `width`-bit values at buf[pos:] (uint64), and
    the byte position after them."""
    nbytes = (width * count + 7) // 8
    if count == 0:
        return np.zeros(0, dtype=np.uint64), pos
    if width % 8 == 0:
        b = width // 8
        raw = np.frombuffer(buf, np.uint8, count * b, pos).reshape(count, b)
        full = np.zeros((count, 8), dtype=np.uint8)
        full[:, 8 - b:] = raw
        return full.view(">u8").ravel().astype(np.uint64), pos + nbytes
    bits = np.unpackbits(np.frombuffer(buf, np.uint8, nbytes, pos))
    bits = bits[:width * count].reshape(count, width).astype(np.uint64)
    weights = np.uint64(1) << np.arange(width - 1, -1, -1, dtype=np.uint64)
    return (bits * weights).sum(axis=1, dtype=np.uint64), pos + nbytes


def _unzigzag(u: np.ndarray) -> np.ndarray:
    u = u.astype(np.uint64)
    return ((u >> np.uint64(1)) ^ (np.uint64(0) - (u & np.uint64(1)))) \
        .view(np.int64)


def _zz(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def rle_v2(buf, count: int, signed: bool) -> np.ndarray:
    parts = []
    got = pos = 0
    while got < count:
        if pos >= len(buf):
            raise _err("integer RLE ends before its values")
        first = buf[pos]
        enc = first >> 6
        if enc == 0:  # short repeat
            w = ((first >> 3) & 7) + 1
            n = (first & 7) + 3
            v = int.from_bytes(bytes(buf[pos + 1:pos + 1 + w]), "big")
            pos += 1 + w
            v = _zz(v) if signed else v
            vals = np.full(n, v, dtype=np.int64 if signed or v < 1 << 63
                           else np.uint64)
        elif enc == 1:  # direct
            w = _WIDTHS[(first >> 1) & 0x1F]
            n = ((first & 1) << 8 | buf[pos + 1]) + 1
            u, pos = _unpack_be(buf, pos + 2, w, n)
            vals = _unzigzag(u) if signed else u
        elif enc == 2:  # patched base
            w = _WIDTHS[(first >> 1) & 0x1F]
            n = ((first & 1) << 8 | buf[pos + 1]) + 1
            third, fourth = buf[pos + 2], buf[pos + 3]
            bw = ((third >> 5) & 7) + 1
            pw = _WIDTHS[third & 0x1F]
            pgw = ((fourth >> 5) & 7) + 1
            pll = fourth & 0x1F
            pos += 4
            base = int.from_bytes(bytes(buf[pos:pos + bw]), "big")
            pos += bw
            msb = 1 << (bw * 8 - 1)
            if base & msb:
                base = -(base & ~msb)
            u, pos = _unpack_be(buf, pos, w, n)
            patches, pos = _unpack_be(buf, pos,
                                      _closest_fixed_bits(pgw + pw), pll)
            vals = u.astype(object)
            idx = 0
            mask = (1 << pw) - 1
            for p in patches.tolist():
                idx += p >> pw
                vals[idx] = int(vals[idx]) | ((p & mask) << w)
            vals = np.asarray([int(v) + base for v in vals.tolist()],
                              dtype=np.int64)
        else:  # delta
            code = (first >> 1) & 0x1F
            w = _WIDTHS[code] if code else 0
            n = ((first & 1) << 8 | buf[pos + 1]) + 1
            pos += 2
            base, pos = read_varint(buf, pos)
            base = _zz(base) if signed else base
            dbase, pos = read_varint(buf, pos)
            dbase = _zz(dbase)
            if w == 0 or n <= 2:
                vals = base + dbase * np.arange(n, dtype=np.int64)
            else:
                d, pos = _unpack_be(buf, pos, w, n - 2)
                vals = np.empty(n, dtype=np.int64)
                vals[0], vals[1] = base, base + dbase
                step = d.astype(np.int64) * (-1 if dbase < 0 else 1)
                vals[2:] = vals[1] + np.cumsum(step)
        take = min(len(vals), count - got)
        vals = np.asarray(vals)[:take]
        # uint64 and int64 parts would concatenate as float64
        parts.append(vals.view(np.int64) if vals.dtype == np.uint64
                     else vals.astype(np.int64))
        got += take
    if not parts:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(parts)


def rle_v1(buf, count: int, signed: bool) -> np.ndarray:
    out = []
    got = pos = 0
    while got < count:
        c = buf[pos]
        pos += 1
        if c < 128:
            n = c + 3
            delta = buf[pos] - 256 if buf[pos] > 127 else buf[pos]
            base, pos = read_varint(buf, pos + 1)
            base = _zz(base) if signed else base
            out.extend(base + delta * i for i in range(n))
        else:
            n = 256 - c
            for _ in range(n):
                v, pos = read_varint(buf, pos)
                out.append(_zz(v) if signed else v)
        got += n
    # an unsigned stream carries the writer's int64 bits
    return np.asarray([v - (1 << 64) if v >= 1 << 63 else v
                       for v in out[:count]], dtype=np.int64)


# ---- reader ------------------------------------------------------------------


def _nanos(encoded: np.ndarray) -> np.ndarray:
    z = encoded & 7
    n = encoded >> 3
    scale = np.where(z > 0, 10 ** (z + 1), 1)
    return n * scale


def _split_strings(data: bytes, lengths: np.ndarray, text: bool) -> list:
    ends = np.cumsum(lengths).tolist()
    starts = [0] + ends[:-1]
    if text:
        return [data[a:b].decode("utf-8") for a, b in zip(starts, ends)]
    return [bytes(data[a:b]) for a, b in zip(starts, ends)]


def _read_column(kind: int, enc: int, streams: dict, nrows: int,
                 name: str):
    """(values, valid, chunk dictionary or None) of one stripe column."""
    present = streams.get(PRESENT)
    valid = bool_rle(present, nrows) if present is not None else \
        np.ones(nrows, dtype=bool)
    nnz = int(valid.sum())
    data = streams.get(DATA, b"")
    v2 = enc in (DIRECT_V2, DICTIONARY_V2)
    ints = rle_v2 if v2 else rle_v1
    chunk_dict = None
    if kind == BOOLEAN:
        vals = bool_rle(data, nnz)
    elif kind == BYTE:
        vals = byte_rle(data, nnz).view(np.int8)
    elif kind in (SHORT, INT, LONG, DATE):
        vals = ints(data, nnz, True)
    elif kind == FLOAT:
        vals = np.frombuffer(data, "<f4", nnz)
    elif kind == DOUBLE:
        vals = np.frombuffer(data, "<f8", nnz)
    elif kind in (STRING, VARCHAR, CHAR, BINARY):
        text = kind != BINARY
        if enc in (DICTIONARY, DICTIONARY_V2):
            size = streams["dict_size"]
            lengths = ints(streams.get(LENGTH, b""), size, False)
            chunk_dict = _split_strings(streams.get(DICTIONARY_DATA, b""),
                                        lengths, text)
            vals = ints(data, nnz, False).astype(np.int32)
        else:
            lengths = ints(streams.get(LENGTH, b""), nnz, False)
            strs = _split_strings(data, lengths, text)
            index: dict = {}
            vals = np.fromiter((index.setdefault(s, len(index))
                                for s in strs), np.int32, nnz)
            chunk_dict = list(index)
    elif kind in (TIMESTAMP, TIMESTAMP_INSTANT):
        secs = ints(data, nnz, True) + EPOCH_2015
        nanos = _nanos(ints(streams.get(SECONDARY, b""), nnz, False)
                       .astype(np.int64))
        secs = np.where((secs < 0) & (nanos > 999_999), secs - 1, secs)
        vals = secs * 1_000_000_000 + nanos
    else:
        raise _err(f"column {name!r}: ORC type kind {kind} is not "
                   "supported by greptimedb_tpu_torch")
    vals = np.asarray(vals)
    if nnz != nrows:
        fill = -1 if chunk_dict is not None else 0
        full = np.full(nrows, fill, dtype=vals.dtype)
        full[valid] = vals
        vals = full
    return vals, valid, chunk_dict


def read(raw: bytes) -> TextTable:
    from greptimedb_tpu_torch.datasource.parquet import merge_coded

    if len(raw) < 4 or raw[:3] != MAGIC:
        raise _err("not an ORC file (no ORC magic)")
    try:
        pslen = raw[-1]
        ps = _fields(raw[-1 - pslen:-1])
        comp = ps.get(2, [0])[0]
        flen = ps[1][0]
        fend = len(raw) - 1 - pslen
        footer = _fields(_decompress(comp, raw[fend - flen:fend]))
        types = [_fields(t) for t in footer.get(4, [])]
        if not types or types[0].get(1, [None])[0] != STRUCT:
            raise _err("the root type is not a STRUCT")
        root = types[0]
        sub = _packed(root.get(2, []))
        names = [n.decode() for n in root.get(3, [])]
        kinds = [types[i].get(1, [0])[0] for i in sub]
        for name, k in zip(names, kinds):
            if k not in _KIND_TYPE:
                raise _err(f"column {name!r}: ORC type kind {k} is not "
                           "supported by greptimedb_tpu_torch")
        per_col: list = [[] for _ in names]
        for si in footer.get(3, []):
            info = _fields(si)
            offset = info[1][0]
            ilen = info.get(2, [0])[0]
            dlen = info.get(3, [0])[0]
            sflen = info.get(4, [0])[0]
            nrows = info.get(5, [0])[0]
            sf = _fields(_decompress(
                comp, raw[offset + ilen + dlen:offset + ilen + dlen + sflen]))
            encodings = [_fields(e) for e in sf.get(2, [])]
            pos = offset
            found: dict = {}
            for st in sf.get(1, []):
                s = _fields(st)
                kind = s.get(1, [0])[0]
                col = s.get(2, [0])[0]
                length = s.get(3, [0])[0]
                if kind not in (ROW_INDEX, 7, 8):
                    found.setdefault(col, {})[kind] = _decompress(
                        comp, raw[pos:pos + length])
                pos += length
            for j, col_id in enumerate(sub):
                e = encodings[col_id] if col_id < len(encodings) else {}
                enc = e.get(1, [DIRECT])[0]
                streams = found.get(col_id, {})
                streams["dict_size"] = e.get(2, [0])[0]
                per_col[j].append(_read_column(kinds[j], enc, streams,
                                               nrows, names[j]))
        total = footer.get(6, [0])[0]
    except DataSourceError:
        raise
    except (IndexError, KeyError, ValueError, struct.error, zlib.error) as e:
        raise _err(f"malformed file: {e}") from None
    columns = {}
    for name, kind, chunks in zip(names, kinds, per_col):
        t = _KIND_TYPE[kind]
        if t in ("string", "binary"):
            columns[name] = merge_coded(chunks, t, total)
            continue
        if chunks:
            vals = np.concatenate([c[0] for c in chunks])
            valid = np.concatenate([c[1] for c in chunks])
        else:
            vals = np.zeros(0, dtype=np.int64)
            valid = np.zeros(0, dtype=bool)
        if t in ("float", "double"):
            vals = np.where(valid, vals, np.nan)
        vals = vals.astype({"bool": np.bool_, "int8": np.int8,
                            "int16": np.int16, "int32": np.int32,
                            "float": np.float32, "date32": np.int32}
                           .get(t, np.int64 if t != "double"
                                else np.float64))
        columns[name] = TextColumn(vals, None if valid.all() else valid, t)
    return TextTable(names, columns, total)


# ---- writer ------------------------------------------------------------------


def _byte_rle_literals(data: bytes) -> bytes:
    out = []
    for i in range(0, len(data), 128):
        chunk = data[i:i + 128]
        out.append(bytes([256 - len(chunk)]))
        out.append(chunk)
    return b"".join(out)


def _bool_stream(bits: np.ndarray) -> bytes:
    return _byte_rle_literals(np.packbits(bits.astype(np.uint8)).tobytes())


def _pack_be(u: np.ndarray, width: int) -> bytes:
    if width % 8 == 0:
        b = width // 8
        return np.ascontiguousarray(
            u.astype(">u8").view(np.uint8).reshape(-1, 8)[:, 8 - b:]
        ).tobytes()
    shifts = np.arange(width - 1, -1, -1, dtype=np.uint64)
    bits = ((u[:, None] >> shifts) & np.uint64(1)).astype(np.uint8)
    return np.packbits(bits.ravel()).tobytes()


def rle_v2_direct(values: np.ndarray, signed: bool) -> bytes:
    """RLE v2 DIRECT runs of 512 values at one width for the stream."""
    if not len(values):
        return b""
    v = np.asarray(values).astype(np.int64)
    u = ((v << 1) ^ (v >> 63)).view(np.uint64) if signed \
        else v.view(np.uint64)
    width = _closest_fixed_bits(max(1, int(u.max()).bit_length()))
    code = _WIDTH_CODE[width]
    out = []
    for r0 in range(0, len(u), 1 << 16):
        block = u[r0:r0 + (1 << 16)]
        packed = _pack_be(block, width)
        per_run = 64 * width  # bytes of 512 values
        for k in range(0, len(block), 512):
            n = min(512, len(block) - k)
            head = 0x40 | (code << 1) | ((n - 1) >> 8)
            out.append(bytes([head, (n - 1) & 0xFF]))
            start = (k // 512) * per_run
            out.append(packed[start:start + (n * width + 7) // 8])
    return b"".join(out)


def _encode_nanos(nanos: np.ndarray) -> np.ndarray:
    out = nanos << 3
    zero = nanos == 0
    n = nanos.copy()
    trail = np.zeros_like(n)
    cand = (n % 100 == 0) & ~zero
    n = np.where(cand, n // 100, n)
    trail = np.where(cand, 1, 0)
    for _ in range(6):
        more = cand & (n % 10 == 0) & (trail < 7)
        n = np.where(more, n // 10, n)
        trail = np.where(more, trail + 1, trail)
    out = np.where(cand, (n << 3) | trail, out)
    return np.where(zero, 0, out)


def _column_streams(col: TextColumn, t: str, r0: int, r1: int,
                    coded) -> tuple[list, bytes]:
    """[(stream kind, bytes)] and the ColumnEncoding of rows [r0, r1)."""
    valid = None if col.valid is None else col.valid[r0:r1]
    streams = []
    if valid is not None and not valid.all():
        streams.append((PRESENT, _bool_stream(valid)))
    else:
        valid = None
    vals = col.values[r0:r1]
    if valid is not None and coded is None:
        vals = vals[valid]
    enc = field_varint(1, DIRECT_V2)
    if t == "bool":
        streams.append((DATA, _bool_stream(np.asarray(vals, dtype=bool))))
        enc = field_varint(1, DIRECT)
    elif t == "int8":
        streams.append((DATA, _byte_rle_literals(
            np.asarray(vals, dtype=np.int8).tobytes())))
        enc = field_varint(1, DIRECT)
    elif t in ("int16", "int32", "int64", "date32"):
        streams.append((DATA, rle_v2_direct(vals, True)))
    elif t == "float":
        streams.append((DATA, np.asarray(vals, "<f4").tobytes()))
        enc = field_varint(1, DIRECT)
    elif t == "double":
        streams.append((DATA, np.asarray(vals, "<f8").tobytes()))
        enc = field_varint(1, DIRECT)
    elif t in _TIME_SCALE:
        ns = np.asarray(vals, dtype=np.int64) * _TIME_SCALE[t]
        secs = np.floor_divide(ns, 1_000_000_000)
        nanos = ns - secs * 1_000_000_000
        secs = np.where((secs < 0) & (nanos > 999_999), secs + 1, secs)
        streams.append((DATA, rle_v2_direct(secs - EPOCH_2015, True)))
        streams.append((SECONDARY, rle_v2_direct(_encode_nanos(nanos),
                                                 False)))
    elif t in ("string", "binary"):
        codes, dictionary = coded
        codes = np.asarray(codes[r0:r1], dtype=np.int64)
        codes = codes[codes >= 0]
        used = np.unique(codes)
        remap = np.zeros(len(dictionary), dtype=np.int64)
        remap[used] = np.arange(len(used))
        blobs = [v.encode("utf-8") if isinstance(v, str) else bytes(v)
                 for v in dictionary[used].tolist()]
        streams.append((DATA, rle_v2_direct(remap[codes], False)))
        streams.append((DICTIONARY_DATA, b"".join(blobs)))
        streams.append((LENGTH, rle_v2_direct(
            np.asarray([len(b) for b in blobs], dtype=np.int64), False)))
        enc = field_varint(1, DICTIONARY_V2) + field_varint(2, len(blobs))
    else:
        raise _err(f"cannot write a column of type {t} (pyarrow's ORC "
                   "writer refuses it too)")
    return streams, enc


def write(table: TextTable, compression: str = "none") -> bytes:
    comp = {"none": 0, "zlib": 1, "snappy": 2}[compression]
    n = table.num_rows
    cols = [table.column(name) for name in table.names]
    tnames = []
    for name, col in zip(table.names, cols):
        t = "string" if col.dictionary is not None and col.type not in (
            "string", "binary") else col.type
        if t not in _TYPE_KIND:
            raise _err(f"column {name!r}: cannot write a column of type "
                       f"{t} (pyarrow's ORC writer refuses it too)")
        tnames.append(t)
    coded = [col.encoded() if t in ("string", "binary") else None
             for col, t in zip(cols, tnames)]
    out = [MAGIC]
    pos = len(MAGIC)
    stripes = []
    for s0 in range(0, n, STRIPE_ROWS):
        s1 = min(n, s0 + STRIPE_ROWS)
        stream_meta = []
        encodings = [field_varint(1, DIRECT)]
        data_len = 0
        start = pos
        for ci, (col, t) in enumerate(zip(cols, tnames), start=1):
            streams, enc = _column_streams(col, t, s0, s1, coded[ci - 1])
            encodings.append(enc)
            for kind, payload in streams:
                payload = _compress(comp, payload)
                out.append(payload)
                pos += len(payload)
                data_len += len(payload)
                stream_meta.append(field_varint(1, kind) + field_varint(
                    2, ci) + field_varint(3, len(payload)))
        sf = b"".join(field_bytes(1, m) for m in stream_meta) + b"".join(
            field_bytes(2, e) for e in encodings) + field_str(3, "UTC")
        sf = _compress(comp, sf)
        out.append(sf)
        pos += len(sf)
        stripes.append(field_varint(1, start) + field_varint(2, 0)
                       + field_varint(3, data_len) + field_varint(4, len(sf))
                       + field_varint(5, s1 - s0))
    root = field_varint(1, STRUCT) + field_bytes(2, b"".join(
        write_varint(i) for i in range(1, len(cols) + 1))) + b"".join(
        field_str(3, name) for name in table.names)
    types = [root] + [field_varint(1, _TYPE_KIND[t]) for t in tnames]
    footer = field_varint(1, len(MAGIC)) + field_varint(2, pos) + b"".join(
        field_bytes(3, s) for s in stripes) + b"".join(
        field_bytes(4, t) for t in types) + field_varint(6, n) \
        + field_varint(8, 0)
    footer = _compress(comp, footer)
    ps = field_varint(1, len(footer)) + field_varint(2, comp) \
        + field_varint(3, BLOCK) + field_bytes(4, b"\x00\x0c") \
        + field_varint(5, 0) + field_varint(6, 6) + field_str(8000, "ORC")
    out.append(footer)
    out.append(ps)
    out.append(bytes([len(ps)]))
    return b"".join(out)
