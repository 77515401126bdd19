"""Native (C++) host hot paths, bound with ctypes (counterpart of
greptimedb_tpu/native/__init__.py).

The sources are host code, not device kernels: src/gtpu_native.cpp (a
copy of the JAX package's: CRC32, the snappy block codec and the WAL
frame scan), src/lp_columns.cpp (the line-protocol vector lane, which
the JAX package runs through pyarrow) and src/text_format.cpp (the CSV
and ndjson writers' number text and row assembly and the ndjson reader's
cell scan, which the JAX package leaves to pyarrow and json). They are
compiled together with `g++ -std=c++17 -O3 -shared -fPIC` at first use
(the first `try_load()`), into greptimedb_tpu_torch/_build/ under a name
keyed by the sources' hash, so an edited source rebuilds. Nothing
compiles at import.

Everything here is optional, as in the JAX package: callers ask
`try_load()` and keep their pure-Python paths when the build fails;
`AVAILABLE` says which route ran.

Exposes:
- crc32(data, seed=0)           — bit-identical to zlib.crc32
- snappy_compress(data)         — real back-reference compression
- snappy_decompress(data)       — block-format decoder
- wal_scan(data)                — one pass over WAL frames
- lp_columns(body, ...)         — the line-protocol column scan
- number_text(values, style)    — a numeric array's texts as one buffer
- text_rows(columns, pieces, n) — rows laid out from column texts
- ndjson_columns(body, keys, n) — the cells of a regular ndjson body
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [os.path.join(_HERE, "src", f)
         for f in ("gtpu_native.cpp", "lp_columns.cpp", "text_format.cpp")]
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

AVAILABLE = False
_lib = None
_tried = False
_LOCK = threading.Lock()


def _build() -> str | None:
    h = hashlib.sha256()
    try:
        for src in _SRCS:
            with open(src, "rb") as f:
                h.update(f.read())
    except OSError:
        return None
    digest = h.hexdigest()[:16]
    so_path = os.path.join(BUILD_DIR, f"libgtpu_native_{digest}.so")
    if os.path.exists(so_path):
        return so_path
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return None
    cmd = ["g++", "-std=c++17", "-O3", "-shared", "-fPIC", "-o", tmp, *_SRCS]
    try:
        r = subprocess.run(cmd, capture_output=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired):
        r = None
    if r is None or r.returncode != 0:
        os.unlink(tmp)
        return None
    # atomic: another process compiling the same sources at once
    # replaces the same bytes, and no reader sees a half-written library
    os.replace(tmp, so_path)
    return so_path


def _load() -> None:
    global _lib, AVAILABLE
    so = _build()
    if so is None:
        return
    try:
        lib = ctypes.CDLL(so)
    except OSError:
        return
    lib.gtpu_crc32.restype = ctypes.c_uint32
    lib.gtpu_crc32.argtypes = [ctypes.c_char_p, ctypes.c_size_t,
                               ctypes.c_uint32]
    lib.gtpu_snappy_max_compressed.restype = ctypes.c_size_t
    lib.gtpu_snappy_max_compressed.argtypes = [ctypes.c_size_t]
    lib.gtpu_snappy_compress.restype = ctypes.c_longlong
    lib.gtpu_snappy_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
    lib.gtpu_snappy_uncompressed_length.restype = ctypes.c_longlong
    lib.gtpu_snappy_uncompressed_length.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t]
    lib.gtpu_snappy_decompress.restype = ctypes.c_longlong
    lib.gtpu_snappy_decompress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
    lib.gtpu_wal_scan.restype = ctypes.c_longlong
    lib.gtpu_wal_scan.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_uint64)]
    _P = ctypes.c_void_p
    lib.gtpu_lp_columns.restype = ctypes.c_longlong
    lib.gtpu_lp_columns.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ctypes.c_char_p, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_size_t, _P, _P, _P, _P]
    lib.gtpu_number_text.restype = ctypes.c_longlong
    lib.gtpu_number_text.argtypes = [_P, ctypes.c_size_t, ctypes.c_int, _P,
                                     ctypes.c_size_t, _P]
    lib.gtpu_text_rows.restype = ctypes.c_longlong
    lib.gtpu_text_rows.argtypes = [ctypes.c_size_t, ctypes.c_int, _P, _P, _P,
                                   _P, _P, _P, ctypes.c_size_t]
    lib.gtpu_ndjson_columns.restype = ctypes.c_longlong
    lib.gtpu_ndjson_columns.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_char_p, _P,
        ctypes.c_size_t, _P, _P, _P]
    _lib = lib
    AVAILABLE = True


def try_load():
    """The guarded accessor every caller uses: builds and loads the
    library on the first call, then returns this module when it loaded,
    else None (a broken toolchain never takes down a pure-Python path)."""
    global _tried
    if not _tried:
        with _LOCK:
            if not _tried:
                _load()
                _tried = True
    return sys.modules[__name__] if AVAILABLE else None


def crc32(data: bytes, seed: int = 0) -> int:
    return _lib.gtpu_crc32(data, len(data), seed & 0xFFFFFFFF)


def snappy_compress(data: bytes) -> bytes:
    cap = _lib.gtpu_snappy_max_compressed(len(data))
    dst = ctypes.create_string_buffer(cap)
    n = _lib.gtpu_snappy_compress(data, len(data), dst, cap)
    if n < 0:
        raise ValueError("snappy compression failed")
    return dst.raw[:n]


def wal_scan(data: bytes):
    """Validate + index WAL frames in one native pass.

    Returns (records, valid_end): records is a list of
    (payload_off, payload_len, region_id, seq, op_type); valid_end is
    the truncation point after the last intact frame."""
    max_records = len(data) // 25 + 1
    off = (ctypes.c_uint64 * max_records)()
    plen = (ctypes.c_uint32 * max_records)()
    rid = (ctypes.c_uint64 * max_records)()
    seq = (ctypes.c_uint64 * max_records)()
    op = (ctypes.c_uint8 * max_records)()
    valid_end = ctypes.c_uint64(0)
    n = _lib.gtpu_wal_scan(data, len(data), off, plen, rid, seq, op,
                           max_records, ctypes.byref(valid_end))
    recs = [(off[i], plen[i], rid[i], seq[i], op[i]) for i in range(n)]
    return recs, valid_end.value


def snappy_decompress(data: bytes) -> bytes:
    want = _lib.gtpu_snappy_uncompressed_length(data, len(data))
    if want < 0:
        raise ValueError("malformed snappy header")
    # the header varint is attacker-controlled (e.g. Prometheus remote
    # write bodies): bound it by the format's maximum expansion (~64x for
    # copy-2 runs) before allocating, or a 7-byte request could demand TBs
    if want > max(64 * len(data), 1 << 16):
        raise ValueError(
            f"snappy header claims {want} bytes from {len(data)} input")
    dst = ctypes.create_string_buffer(max(int(want), 1))
    n = _lib.gtpu_snappy_decompress(data, len(data), dst, want)
    if n == -1:
        raise ValueError("malformed snappy data")
    if n == -2:
        raise ValueError("snappy output overflow")
    return dst.raw[:n]


def lp_columns(body: bytes, measurement: str, tag_keys: list,
               field_keys: list, has_ts: bool, max_rows: int):
    """Scan a line-protocol body of one measurement whose every line
    carries `tag_keys` then `field_keys` in that order (one native pass,
    the GIL released). Returns (tag_off [T, n] uint32, tag_len [T, n]
    uint32, fields [F, n] float64, ts [n] int64 raw), or None when the
    body leaves the lane's strict shape (lp_columns.cpp says which)."""
    import numpy as np

    if len(body) >= 1 << 32:
        return None  # tag offsets are uint32
    keys = [k.encode() for k in list(tag_keys) + list(field_keys)]
    key_lens = np.asarray([len(k) for k in keys], dtype=np.uint32)
    tag_off = np.empty((len(tag_keys), max_rows), dtype=np.uint32)
    tag_len = np.empty((len(tag_keys), max_rows), dtype=np.uint32)
    fields = np.empty((len(field_keys), max_rows), dtype=np.float64)
    ts = np.empty(max_rows, dtype=np.int64)
    meas = measurement.encode()
    n = _lib.gtpu_lp_columns(
        body, len(body), meas, len(meas), b"".join(keys),
        key_lens.ctypes.data, len(tag_keys), len(field_keys),
        int(has_ts), max_rows, tag_off.ctypes.data, tag_len.ctypes.data,
        fields.ctypes.data, ts.ctypes.data)
    if n != max_rows:
        return None
    return tag_off, tag_len, fields, ts


#: gtpu_number_text's kinds: (style, numpy dtype) -> kind
_NUMBER_KINDS = {("arrow", "float32"): 0, ("arrow", "float64"): 1,
                 ("repr", "float32"): 2, ("repr", "float64"): 3,
                 ("int", "int64"): 4, ("int", "uint64"): 5}
#: bytes one value's text can take (text_format.cpp's kMaxText)
_MAX_TEXT = 32


def number_text(values, style: str):
    """Texts of a float32 / float64 array (`style` "arrow": pyarrow's CSV
    text; "repr": Python's repr of the widened double, as the ndjson
    writer spells it) or an int64 / uint64 array (`style` "int") in one
    native pass. Returns (buf uint8, offs int64 [n + 1]): value i is
    buf[offs[i]:offs[i + 1]]."""
    import numpy as np

    values = np.ascontiguousarray(values)
    kind = _NUMBER_KINDS[(style, values.dtype.name)]
    n = len(values)
    cap = _MAX_TEXT * n
    buf = np.empty(cap, dtype=np.uint8)
    offs = np.empty(n + 1, dtype=np.int64)
    got = _lib.gtpu_number_text(values.ctypes.data, n, kind, buf.ctypes.data,
                                cap, offs.ctypes.data)
    if got < 0:
        raise ValueError(f"number_text: {style} text of {values.dtype} "
                         "overflowed its buffer")
    return buf[:got], offs


def text_rows(columns, pieces, nrows: int) -> bytes:
    """Rows of `nrows` laid out natively: row r is pieces[0], column 0's
    text of r, pieces[1], ..., the last column's, pieces[-1]. Each column
    is (buf uint8, offs int64, index int32 or None): its text of row r is
    entry index[r] (or r), buf[offs[e]:offs[e + 1]]."""
    import numpy as np

    cols = [(np.ascontiguousarray(b, dtype=np.uint8),
             np.ascontiguousarray(o, dtype=np.int64),
             None if i is None else np.ascontiguousarray(i, dtype=np.int32))
            for b, o, i in columns]
    if len(pieces) != len(cols) + 1:
        raise ValueError(f"text_rows: {len(pieces)} pieces for "
                         f"{len(cols)} columns")
    enc = [p.encode() for p in pieces]
    piece_offs = np.zeros(len(enc) + 1, dtype=np.int64)
    piece_offs[1:] = np.cumsum([len(p) for p in enc])
    total = int(piece_offs[-1]) * nrows
    for buf, offs, index in cols:
        lens = np.diff(offs)
        if index is None:
            if len(lens) < nrows:
                raise ValueError("text_rows: a column has fewer texts "
                                 "than rows")
            total += int(lens[:nrows].sum())
        else:
            if len(index) < nrows or (nrows and (
                    int(index[:nrows].min()) < 0
                    or int(index[:nrows].max()) >= len(lens))):
                raise ValueError("text_rows: a column index is out of "
                                 "its entries")
            total += int(lens[index[:nrows]].sum())
    out = np.empty(max(total, 1), dtype=np.uint8)
    k = len(cols)
    ptrs = (ctypes.c_void_p * max(k, 1))(*[b.ctypes.data for b, _, _ in cols])
    offp = (ctypes.c_void_p * max(k, 1))(*[o.ctypes.data for _, o, _ in cols])
    idxp = (ctypes.c_void_p * max(k, 1))(
        *[None if i is None else i.ctypes.data for _, _, i in cols])
    pieces_buf = b"".join(enc)
    got = _lib.gtpu_text_rows(nrows, k, ptrs, offp, idxp, pieces_buf,
                              piece_offs.ctypes.data, out.ctypes.data,
                              total)
    if got != total:
        raise ValueError(f"text_rows: wrote {got} of {total} bytes")
    return out[:total].tobytes()


#: gtpu_ndjson_columns' cell kinds
NDJSON_NULL, NDJSON_INT, NDJSON_FLOAT, NDJSON_BOOL, NDJSON_STR = range(5)


def ndjson_columns(body: bytes, keys: list, nrows: int):
    """Scan an ndjson body whose `nrows` lines are each one object with
    `keys` in that order (text_format.cpp says which values it takes) in
    one native pass, the GIL released. Returns (kinds uint8, slots int64,
    lens uint32), each [len(keys), nrows]: a cell's kind (NDJSON_*), and
    its int, its double's bits, 0 / 1, or its string's byte offset in
    `body` (`lens` its length); None when the body leaves that shape."""
    import numpy as np

    enc = [k.encode() for k in keys]
    key_lens = np.asarray([len(k) for k in enc], dtype=np.uint32)
    shape = (len(keys), nrows)
    kinds = np.empty(shape, dtype=np.uint8)
    slots = np.empty(shape, dtype=np.int64)
    lens = np.empty(shape, dtype=np.uint32)
    got = _lib.gtpu_ndjson_columns(
        body, len(body), len(keys), b"".join(enc), key_lens.ctypes.data,
        nrows, kinds.ctypes.data, slots.ctypes.data, lens.ctypes.data)
    if got != nrows:
        return None
    return kinds, slots, lens
