"""Parquet, read and written by hand (the JAX package uses
`pyarrow.parquet`; the port has no pyarrow). The footer and the page
headers are Thrift compact structs (`thrift.py`); field ids below are
parquet.thrift's.

Reader (`read(raw) -> TextTable`): flat schemas (a nested or repeated
column raises `DataSourceError`); data pages v1 and v2; dictionary pages
with PLAIN_DICTIONARY / RLE_DICTIONARY indices, PLAIN values, RLE
booleans; RLE / bit-packed definition levels; codecs UNCOMPRESSED,
SNAPPY and GZIP (a codec the port cannot decode, such as ZSTD, LZ4 or
BROTLI, raises a `DataSourceError` naming it; no rows come back).
Types: BOOLEAN, INT32 / INT64 (INT(8|16|32|64, signed or not), DATE,
TIMESTAMP in MILLIS / MICROS / NANOS, UTC-adjusted or not, and the
legacy converted types), INT96 (timestamp[ns]), FLOAT, DOUBLE,
BYTE_ARRAY (string when STRING / UTF8, else binary). Strings come back
dictionary-encoded: the row groups' dictionaries merge into one.

Writer (`write(table) -> bytes`): format 2.6 layout as pyarrow writes it
by default (OPTIONAL leaves with logical and converted types, data page
v1, RLE definition levels, SNAPPY), strings as a dictionary page and
RLE_DICTIONARY indices, everything else PLAIN; row groups of 1 Mi rows
(pyarrow's default), pages of 64 Ki rows. A timestamp[s] column is
written as MILLIS (Parquet has no seconds unit), as pyarrow writes it;
both files read back as timestamp[ms].
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from greptimedb_tpu_torch.datasource import (
    NUMPY_OF,
    DataSourceError,
    TextColumn,
    TextTable,
)
from greptimedb_tpu_torch.datasource import thrift as th
from greptimedb_tpu_torch.datasource.thrift import Struct

MAGIC = b"PAR1"

# physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED = range(8)
# encodings
PLAIN, PLAIN_DICTIONARY, RLE, BIT_PACKED, RLE_DICTIONARY = 0, 2, 3, 4, 8
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE",
                  4: "BIT_PACKED", 5: "DELTA_BINARY_PACKED",
                  6: "DELTA_LENGTH_BYTE_ARRAY", 7: "DELTA_BYTE_ARRAY",
                  8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO",
               4: "BROTLI", 5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
# page types
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
OPTIONAL, REPEATED = 1, 2

ROW_GROUP_ROWS = 1 << 20
PAGE_ROWS = 1 << 16

#: converted type -> column type (the legacy annotations)
_CONVERTED = {0: "string", 6: "date32", 9: "timestamp[ms]",
              10: "timestamp[us]", 11: "uint8", 12: "uint16",
              13: "uint32", 14: "uint64", 15: "int8", 16: "int16",
              17: "int32", 18: "int64"}
_TS_UNIT = {1: "timestamp[ms]", 2: "timestamp[us]", 3: "timestamp[ns]"}


def _err(msg: str) -> DataSourceError:
    return DataSourceError(f"parquet: {msg}")


# ---- the RLE / bit-packed hybrid ---------------------------------------------


def _varint(buf, pos: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def rle_decode(buf, pos: int, end: int, bw: int, count: int) -> np.ndarray:
    """`count` values of bit width `bw` from the hybrid runs at
    buf[pos:end] (int64)."""
    out = np.zeros(count, dtype=np.int64)
    filled = 0
    width = (bw + 7) // 8
    weights = (1 << np.arange(bw, dtype=np.int64)) if bw else None
    while filled < count and pos < end:
        header, pos = _varint(buf, pos)
        if header & 1:
            groups = header >> 1
            nbytes = groups * bw
            take = min(groups * 8, count - filled)
            if bw:
                chunk = np.frombuffer(buf, np.uint8, nbytes, pos)
                bits = np.unpackbits(chunk, bitorder="little")
                vals = bits.reshape(-1, bw)[:take].astype(np.int64) @ weights
                out[filled:filled + take] = vals
            pos += nbytes
        else:
            run = header >> 1
            v = int.from_bytes(bytes(buf[pos:pos + width]), "little")
            pos += width
            take = min(run, count - filled)
            out[filled:filled + take] = v
        filled += take
    if filled < count:
        raise _err("RLE run ends before its values")
    return out


def rle_encode(values: np.ndarray, bw: int) -> bytes:
    """One bit-packed run of `values` (one RLE run when all are equal)."""
    n = len(values)
    if n and bool((values == values[0]).all()):
        width = (bw + 7) // 8
        return _enc_varint(n << 1) + int(values[0]).to_bytes(width, "little")
    groups = (n + 7) // 8
    padded = np.zeros(groups * 8, dtype=np.int64)
    padded[:n] = values
    bits = ((padded[:, None] >> np.arange(bw, dtype=np.int64)) & 1) \
        .astype(np.uint8)
    return _enc_varint((groups << 1) | 1) + \
        np.packbits(bits.ravel(), bitorder="little").tobytes()


def _enc_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


# ---- codecs ------------------------------------------------------------------


def _decompress(codec: int, data: bytes, size: int) -> bytes:
    if codec == 0:
        return data
    if codec == 1:
        from greptimedb_tpu_torch.utils import snappy

        return snappy.decompress(data)
    if codec == 2:
        return zlib.decompress(data, 31)
    raise _err(f"compression codec {CODEC_NAMES.get(codec, codec)} is not "
               "supported by greptimedb_tpu_torch (supported: UNCOMPRESSED, "
               "SNAPPY, GZIP)")


def _compress(codec: int, data: bytes) -> bytes:
    if codec == 1:
        from greptimedb_tpu_torch.utils import snappy

        return snappy.compress(data)
    if codec == 2:
        c = zlib.compressobj(6, zlib.DEFLATED, 31)
        return c.compress(data) + c.flush()
    return data


# ---- reader ------------------------------------------------------------------


def _column_type(el: dict) -> str:
    ptype = el.get(1)
    logical = el.get(10) or {}
    conv = el.get(6)
    if ptype == BOOLEAN:
        return "bool"
    if ptype in (INT32, INT64):
        if 11 in logical:
            return "null"
        if 10 in logical:
            bits, signed = logical[10].get(1, 64), logical[10].get(2, True)
            return f"{'' if signed else 'u'}int{bits}"
        if 8 in logical:
            unit = next(iter(logical[8].get(2, {1: {}})))
            return _TS_UNIT[unit]
        if 6 in logical:
            return "date32"
        if conv in _CONVERTED and conv != 0:
            return _CONVERTED[conv]
        if logical or conv is not None:
            raise _err(f"column {el.get(4, b'').decode()!r}: logical type "
                       f"{logical or conv} is not supported")
        return "int32" if ptype == INT32 else "int64"
    if ptype == INT96:
        return "timestamp[ns]"
    if ptype == FLOAT:
        return "float"
    if ptype == DOUBLE:
        return "double"
    if ptype == BYTE_ARRAY:
        if 1 in logical or conv == 0 or 4 in logical or 12 in logical:
            return "string"
        return "binary"
    raise _err(f"column {el.get(4, b'').decode()!r}: physical type "
               f"{ptype} is not supported")


def _plain(buf: bytes, ptype: int, count: int, type_name: str):
    """`count` PLAIN values: a numpy array, or a list of str / bytes."""
    if ptype == BOOLEAN:
        bits = np.unpackbits(np.frombuffer(buf, np.uint8,
                                           (count + 7) // 8),
                             bitorder="little")
        return bits[:count].astype(bool)
    if ptype == INT96:
        raw = np.frombuffer(buf, np.uint8, count * 12).reshape(count, 12)
        nanos = raw[:, :8].copy().view("<i8").ravel()
        days = raw[:, 8:].copy().view("<i4").ravel().astype(np.int64)
        return (days - 2440588) * 86_400_000_000_000 + nanos
    if ptype in (INT32, INT64, FLOAT, DOUBLE):
        dt = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[ptype]
        return np.frombuffer(buf, dt, count)
    if ptype == BYTE_ARRAY:
        out = []
        pos = 0
        text = type_name == "string"
        unpack = struct.Struct("<I").unpack_from
        for _ in range(count):
            (n,) = unpack(buf, pos)
            pos += 4
            v = bytes(buf[pos:pos + n])
            out.append(v.decode("utf-8") if text else v)
            pos += n
        return out
    raise _err(f"physical type {ptype} is not supported")


class _ChunkDecoder:
    """The pages of one column chunk, into values, validity and (for
    strings) codes into the chunk's dictionary."""

    def __init__(self, el: dict, type_name: str):
        self.ptype = el.get(1)
        self.optional = el.get(3, 0) == OPTIONAL
        self.type = type_name
        self.strings = self.ptype == BYTE_ARRAY
        self.dictionary = None
        self.str_index: dict = {}
        self.str_values: list = []
        self.parts: list = []
        self.valid_parts: list = []

    def _dict_values(self, vals):
        if self.strings:
            self.str_values = list(vals)
            self.str_index = {v: i for i, v in enumerate(self.str_values)}
        self.dictionary = vals

    def _encode_strings(self, vals: list) -> np.ndarray:
        idx = self.str_index
        table = self.str_values
        out = np.empty(len(vals), dtype=np.int32)
        for i, v in enumerate(vals):
            code = idx.get(v)
            if code is None:
                code = idx[v] = len(table)
                table.append(v)
            out[i] = code
        return out

    def page(self, data: bytes, num_values: int, encoding: int,
             valid) -> None:
        nnz = num_values if valid is None else int(valid.sum())
        if encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if self.dictionary is None:
                raise _err("dictionary-encoded page without a dictionary")
            bw = data[0]
            idx = rle_decode(data, 1, len(data), bw, nnz)
            vals = idx.astype(np.int32) if self.strings \
                else np.asarray(self.dictionary)[idx]
        elif encoding == PLAIN:
            vals = _plain(data, self.ptype, nnz, self.type)
            if self.strings:
                vals = self._encode_strings(vals)
        elif encoding == RLE and self.ptype == BOOLEAN:
            (n,) = struct.unpack_from("<I", data, 0)
            vals = rle_decode(data, 4, 4 + n, 1, nnz).astype(bool)
        else:
            raise _err(f"encoding {ENCODING_NAMES.get(encoding, encoding)} "
                       "is not supported by greptimedb_tpu_torch")
        vals = np.asarray(vals)
        if valid is not None and nnz != num_values:
            fill = -1 if self.strings else 0
            full = np.full(num_values, fill, dtype=vals.dtype)
            full[valid] = vals
            vals = full
        self.parts.append(vals)
        self.valid_parts.append(np.ones(num_values, dtype=bool)
                                if valid is None else valid)

    def read(self, raw: bytes, meta: dict) -> None:
        codec = meta.get(4, 0)
        start = meta.get(9)
        if meta.get(11) is not None and 0 < meta[11] < start:
            start = meta[11]
        end = start + meta[7]
        pos = start
        while pos < end:
            hdr, pos = th.read_struct(raw, pos)
            ptype, csize, usize = hdr[1], hdr[3], hdr[2]
            body = raw[pos:pos + csize]
            pos += csize
            if ptype == DICTIONARY_PAGE:
                dh = hdr.get(7, {})
                data = _decompress(codec, body, usize)
                self._dict_values(_plain(data, self.ptype, dh.get(1, 0),
                                         self.type))
            elif ptype == DATA_PAGE:
                dh = hdr[5]
                data = _decompress(codec, body, usize)
                n = dh[1]
                valid, off = None, 0
                if self.optional:
                    (dlen,) = struct.unpack_from("<I", data, 0)
                    if dh.get(3, RLE) != RLE:
                        raise _err("BIT_PACKED definition levels are not "
                                   "supported")
                    levels = rle_decode(data, 4, 4 + dlen, 1, n)
                    valid = levels.astype(bool)
                    off = 4 + dlen
                self.page(data[off:], n, dh[2], valid)
            elif ptype == DATA_PAGE_V2:
                dh = hdr[8]
                n = dh[1]
                dlen, rlen = dh.get(5, 0), dh.get(6, 0)
                if rlen:
                    raise _err("repeated columns are not supported")
                valid = None
                if self.optional and dlen:
                    valid = rle_decode(body, 0, dlen, 1, n).astype(bool)
                rest = body[dlen + rlen:]
                if dh.get(7, True):
                    rest = _decompress(codec, rest,
                                       usize - dlen - rlen)
                self.page(rest, n, dh[4], valid)
            # index pages and unknown page types are skipped

    def column(self):
        """(values, valid or None, chunk dictionary or None)."""
        if self.parts:
            vals = np.concatenate(self.parts)
            valid = np.concatenate(self.valid_parts)
        else:
            vals = np.zeros(0, dtype=np.int32 if self.strings else np.int64)
            valid = np.zeros(0, dtype=bool)
        if self.strings:
            vals = np.where(valid, vals, -1).astype(np.int32)
            return vals, valid, self.str_values
        return vals, valid, None


def _typed(vals: np.ndarray, type_name: str) -> np.ndarray:
    if type_name in NUMPY_OF:
        want = NUMPY_OF[type_name]
        if type_name.startswith("uint"):
            return vals.astype(np.dtype(want).str.replace("u", "i")) \
                .view(want)
        return vals.astype(want)
    return vals.astype(np.int64) if type_name != "date32" \
        else vals.astype(np.int32)


def read(raw: bytes) -> TextTable:
    if len(raw) < 12 or raw[:4] != MAGIC or raw[-4:] != MAGIC:
        raise _err("not a Parquet file (no PAR1 magic)")
    (flen,) = struct.unpack_from("<I", raw, len(raw) - 8)
    try:
        meta, _ = th.read_struct(raw, len(raw) - 8 - flen)
    except (th.ThriftError, IndexError) as e:
        raise _err(f"malformed footer: {e}") from None
    schema = meta.get(2, [])
    if not schema:
        raise _err("empty schema")
    leaves = schema[1:]
    if schema[0].get(5, len(leaves)) != len(leaves) or any(
            el.get(5) for el in leaves):
        raise _err("nested columns are not supported by "
                   "greptimedb_tpu_torch")
    if any(el.get(3) == REPEATED for el in leaves):
        raise _err("repeated columns are not supported by "
                   "greptimedb_tpu_torch")
    names = [el[4].decode() for el in leaves]
    types = [_column_type(el) for el in leaves]
    per_col: list = [[] for _ in leaves]
    for rg in meta.get(4, []):
        for i, cc in enumerate(rg[1]):
            md = cc.get(3)
            if md is None:
                raise _err("column chunk without metadata")
            dec = _ChunkDecoder(leaves[i], types[i])
            try:
                dec.read(raw, md)
            except (th.ThriftError, IndexError, struct.error,
                    zlib.error, ValueError) as e:
                if isinstance(e, DataSourceError):
                    raise
                raise _err(f"malformed column chunk: {e}") from None
            per_col[i].append(dec.column())
    columns = {}
    nrows = int(meta.get(3, 0))
    for name, type_name, chunks, el in zip(names, types, per_col, leaves):
        columns[name] = _merge(chunks, type_name, el.get(1), nrows)
    return TextTable(names, columns, nrows)


def _merge(chunks: list, type_name: str, ptype: int,
           nrows: int) -> TextColumn:
    if ptype == BYTE_ARRAY:
        return merge_coded(chunks, type_name, nrows)
    if chunks:
        vals = np.concatenate([c[0] for c in chunks])
        valid = np.concatenate([c[1] for c in chunks])
    else:
        vals = np.zeros(nrows, dtype=np.int64)
        valid = np.ones(nrows, dtype=bool)
    vals = _typed(vals, type_name)
    if type_name in ("float", "double"):
        vals = np.where(valid, vals, np.nan).astype(vals.dtype)
    return TextColumn(vals, None if valid.all() else valid, type_name)


def merge_coded(chunks: list, type_name: str, nrows: int) -> TextColumn:
    """One dictionary column of (codes, valid, chunk dictionary) chunks:
    the chunks' dictionaries merge in first-seen order."""
    index: dict = {}
    merged: list = []
    codes = []
    for vals, _valid, chunk_dict in chunks:
        remap = np.empty(len(chunk_dict) + 1, dtype=np.int32)
        for j, v in enumerate(chunk_dict):
            code = index.get(v)
            if code is None:
                code = index[v] = len(merged)
                merged.append(v)
            remap[j] = code
        remap[-1] = -1
        codes.append(remap[vals])
    allc = np.concatenate(codes) if codes else \
        np.zeros(nrows, dtype=np.int32)
    dictionary = np.empty(len(merged), dtype=object)
    dictionary[:] = merged
    return TextColumn.of_codes(allc, dictionary, type_name)


# ---- writer ------------------------------------------------------------------

def _leaf_schema(name: str, t: str) -> tuple[int, Struct]:
    """(physical type, the SchemaElement) of a column of type `t`."""
    el = Struct()
    logical = None
    conv = None
    if t == "bool":
        ptype = BOOLEAN
    elif t in ("float", "double"):
        ptype = FLOAT if t == "float" else DOUBLE
    elif t in ("string", "binary"):
        ptype = BYTE_ARRAY
        if t == "string":
            conv, logical = 0, Struct().struct(1, Struct())
    elif t.startswith("timestamp["):
        ptype = INT64
        unit = {"timestamp[s]": 1, "timestamp[ms]": 1, "timestamp[us]": 2,
                "timestamp[ns]": 3}[t]
        logical = Struct().struct(8, Struct().bool(1, False).struct(
            2, Struct().struct(unit, Struct())))
    elif t == "date32":
        ptype, conv, logical = INT32, 6, Struct().struct(6, Struct())
    elif t.startswith("int") or t.startswith("uint"):
        signed = t.startswith("int")
        bits = int(t[3:] if signed else t[4:])
        ptype = INT64 if bits == 64 else INT32
        conv = {8: 15, 16: 16, 32: 17, 64: 18}[bits] - (0 if signed else 4)
        logical = Struct().struct(10, Struct().byte(1, bits).bool(2, signed))
    elif t == "null":
        ptype = INT32
        logical = Struct().struct(11, Struct())
    else:
        raise _err(f"cannot write a column of type {t}")
    el.i32(1, ptype).i32(3, OPTIONAL).binary(4, name)
    if conv is not None:
        el.i32(6, conv)
    if logical is not None:
        el.struct(10, logical)
    return ptype, el


def _plain_bytes(ptype: int, vals) -> bytes:
    if ptype == BOOLEAN:
        return np.packbits(np.asarray(vals, dtype=np.uint8),
                           bitorder="little").tobytes()
    if ptype == BYTE_ARRAY:
        parts = []
        for v in vals:
            b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
            parts.append(struct.pack("<I", len(b)))
            parts.append(b)
        return b"".join(parts)
    dt = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}[ptype]
    return np.ascontiguousarray(vals).astype(dt).tobytes()


class _Out:
    def __init__(self):
        self.parts = [MAGIC]
        self.pos = len(MAGIC)

    def put(self, b: bytes) -> int:
        at = self.pos
        self.parts.append(b)
        self.pos += len(b)
        return at


def _page(out: _Out, codec: int, ptype_page: int, body: bytes,
          header: Struct) -> tuple[int, int, int]:
    """Write one page; (offset, compressed bytes with header,
    uncompressed bytes with header)."""
    comp = _compress(codec, body)
    h = Struct().i32(1, ptype_page).i32(2, len(body)).i32(3, len(comp))
    h.struct(5 if ptype_page == DATA_PAGE else 7, header)
    hb = h.encode()
    at = out.put(hb)
    out.put(comp)
    return at, len(hb) + len(comp), len(hb) + len(body)


def _column_values(col: TextColumn, t: str, ptype: int):
    """(values to write, valid) with times in the written unit."""
    valid = col.valid
    vals = col.values
    if t == "timestamp[s]":
        vals = vals.astype(np.int64) * 1000
    elif t == "null":
        valid = np.zeros(len(col), dtype=bool)
    return vals, valid


def write(table: TextTable, codec: str = "snappy") -> bytes:
    codec_id = {"none": 0, "uncompressed": 0, "snappy": 1, "gzip": 2}[codec]
    out = _Out()
    n = table.num_rows
    leaves = []
    for name in table.names:
        col = table.column(name)
        t = col.type
        if col.dictionary is not None:
            t = "string" if t not in ("string", "binary") else t
        leaves.append(_leaf_schema(name, t) + (t,))
    row_groups = []
    for g0 in range(0, max(n, 1), ROW_GROUP_ROWS):
        g1 = min(n, g0 + ROW_GROUP_ROWS)
        chunks = []
        rg_bytes = rg_comp = 0
        rg_start = out.pos
        for name, (ptype, _el, t) in zip(table.names, leaves):
            col = table.column(name)
            (at, md), usize, csize = _write_chunk(out, codec_id, col, t,
                                                  ptype, g0, g1, name)
            rg_bytes += usize
            rg_comp += csize
            chunks.append(Struct().i64(2, at).struct(3, md))
        row_groups.append(Struct().list(1, th.STRUCT, chunks)
                          .i64(2, rg_bytes).i64(3, g1 - g0)
                          .i64(5, rg_start).i64(6, rg_comp)
                          .i16(7, len(row_groups)))
        if n == 0:
            break
    root = Struct().binary(4, "schema").i32(5, len(leaves))
    fmd = Struct().i32(1, 2).list(2, th.STRUCT, [root] + [
        el for _p, el, _t in leaves]).i64(3, n).list(
        4, th.STRUCT, row_groups).binary(6, "greptimedb_tpu_torch")
    footer = fmd.encode()
    out.put(footer)
    out.put(struct.pack("<I", len(footer)) + MAGIC)
    return b"".join(out.parts)


def _write_chunk(out: _Out, codec: int, col: TextColumn, t: str,
                 ptype: int, g0: int, g1: int, name: str):
    vals, valid = _column_values(col, t, ptype)
    start = out.pos
    usize = csize = 0
    dict_off = None
    encodings = [PLAIN, RLE]
    if ptype == BYTE_ARRAY:
        codes, dictionary = col.encoded()
        codes = np.asarray(codes[g0:g1], dtype=np.int64)
        used = np.unique(codes[codes >= 0])
        remap = np.full(len(dictionary) + 1, -1, dtype=np.int64)
        remap[used] = np.arange(len(used))
        codes = remap[codes]
        dict_vals = [dictionary[i] for i in used.tolist()]
        dict_off, c, u = _page(out, codec, DICTIONARY_PAGE,
                               _plain_bytes(ptype, dict_vals),
                               Struct().i32(1, len(dict_vals))
                               .i32(2, PLAIN_DICTIONARY))
        csize += c
        usize += u
        bw = max(1, (len(dict_vals) - 1).bit_length())
        encodings = [PLAIN_DICTIONARY, RLE, RLE_DICTIONARY]
    data_off = None
    for p0 in range(g0, max(g1, g0 + 1), PAGE_ROWS):
        p1 = min(g1, p0 + PAGE_ROWS)
        ok = np.ones(p1 - p0, dtype=bool) if valid is None \
            else np.asarray(valid[p0:p1], dtype=bool)
        levels = rle_encode(ok.astype(np.int64), 1)
        parts = [struct.pack("<I", len(levels)), levels]
        if ptype == BYTE_ARRAY:
            page_codes = codes[p0 - g0:p1 - g0]
            parts.append(bytes([bw]))
            parts.append(rle_encode(page_codes[page_codes >= 0], bw))
            enc = RLE_DICTIONARY
        else:
            parts.append(_plain_bytes(ptype, vals[p0:p1][ok]))
            enc = PLAIN
        at, c, u = _page(out, codec, DATA_PAGE, b"".join(parts),
                         Struct().i32(1, p1 - p0).i32(2, enc).i32(3, RLE)
                         .i32(4, RLE))
        data_off = at if data_off is None else data_off
        csize += c
        usize += u
        if p1 >= g1:
            break
    md = Struct().i32(1, ptype).list(2, th.I32, encodings).list(
        3, th.BINARY, [name]).i32(4, codec).i64(5, g1 - g0).i64(
        6, usize).i64(7, csize).i64(9, data_off)
    if dict_off is not None:
        md.i64(11, dict_off)
    return (start, md), usize, csize
