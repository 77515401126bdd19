"""The port's native host library (greptimedb_tpu_torch/native, built with
g++ at first use) against zlib, the JAX package's native library and the
pure-Python codecs: CRC32, the snappy block codec (compared on
decompressed bytes: the two packages' encoders may emit different bytes
for the same input), the WAL frame scan, and the port's WAL replay with
and without the native scan (same entries, same truncation point).
"""

import os
import random
import struct
import zlib

import numpy as np
import pytest

from greptimedb_tpu import native as jnative
from greptimedb_tpu.utils import snappy as jsnappy
from greptimedb_tpu_torch import native
from greptimedb_tpu_torch.datatypes import (
    ColumnSchema,
    DataType,
    DictVector,
    RecordBatch,
    Schema,
    SemanticType,
)
from greptimedb_tpu_torch.storage import wal as wal_mod
from greptimedb_tpu_torch.storage.wal import Wal
from greptimedb_tpu_torch.utils import snappy


def test_the_library_builds_and_loads():
    """g++ is on every machine the port runs on: the native route is the
    one that runs, and the library lives in the port's build dir."""
    assert native.try_load() is native
    assert native.AVAILABLE
    built = [f for f in os.listdir(native.BUILD_DIR)
             if f.startswith("libgtpu_native_")]
    assert built


def _payloads(seed: int, n: int) -> list:
    rng = random.Random(seed)
    out = [b"", b"x", b"hello world" * 100, bytes(range(256)) * 300]
    for i in range(n):
        kind = i % 3
        if kind == 0:
            out.append(rng.randbytes(rng.randrange(0, 4096)))
        elif kind == 1:
            out.append((b"metric_%d{host=h%d} " % (i, i % 7)) * (i * 3))
        else:
            out.append(bytes(rng.choices(b"xyz", k=rng.randrange(0, 6000))))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_crc32_matches_zlib_and_jax(seed):
    rng = random.Random(seed)
    for data in _payloads(seed, 30):
        s = rng.randrange(1 << 32)
        assert native.crc32(data) == zlib.crc32(data) == jnative.crc32(data)
        assert native.crc32(data, s) == zlib.crc32(data, s) \
            == jnative.crc32(data, s)
    a, b = b"hello ", b"world"
    assert native.crc32(b, native.crc32(a)) == zlib.crc32(a + b)


@pytest.mark.parametrize("seed", range(4))
def test_snappy_codecs_interoperate_across_packages(seed):
    for data in _payloads(seed + 10, 40):
        encoded = {"port": snappy.compress(data),
                   "port_py": snappy._py_compress(data),
                   "jax": jsnappy.compress(data),
                   "jax_py": jsnappy._py_compress(data)}
        for blob in encoded.values():
            assert snappy.decompress(blob) == data
            assert snappy._py_decompress(blob) == data
            assert jsnappy.decompress(blob) == data
        # the port's pure-Python encoder is the JAX package's, byte for byte
        assert encoded["port_py"] == encoded["jax_py"]


def test_snappy_backreferences_compress_and_bad_input_raises():
    data = b"tsbs,host=host_1 usage=55.3 " * 4000
    assert len(snappy.compress(data)) < len(data) // 10
    with pytest.raises(snappy.SnappyError):
        snappy.decompress(bytes([100]) + b"\x00")
    with pytest.raises(snappy.SnappyError):
        snappy._py_decompress(bytes([100]) + b"\x00")
    # literal "abcd" + copy-1(offset=4, len=4); literal "a" + overlap RLE
    assert snappy.decompress(bytes([8, 3 << 2]) + b"abcd"
                             + bytes([1, 4])) == b"abcdabcd"
    assert snappy.decompress(bytes([8, 0]) + b"a"
                             + bytes([(3 << 2) | 1, 1])) == b"aaaaaaaa"


def test_snappy_header_bomb_rejected_before_allocation():
    """A tiny body whose varint header claims terabytes is rejected up
    front, with the JAX text (remote-write DoS guard)."""
    bomb = bytes([0xFF, 0xFF, 0xFF, 0xFF, 0xFF, 0x0F])
    with pytest.raises(ValueError, match="claims") as ei:
        native.snappy_decompress(bomb)
    with pytest.raises(ValueError) as ej:
        jnative.snappy_decompress(bomb)
    assert str(ei.value) == str(ej.value)
    with pytest.raises(snappy.SnappyError, match="claims"):
        snappy.decompress(bomb)


_HDR = struct.Struct("<IIQQB")


def _frame(rid, seq, op, payload):
    return _HDR.pack(len(payload), zlib.crc32(payload), rid, seq,
                     op) + payload


def test_wal_scan_matches_jax_with_torn_and_corrupt_tails():
    buf = (_frame(1, 10, 0, b"alpha") + _frame(1, 11, 1, b"beta!")
           + _frame(2, 12, 0, b""))
    bad = bytearray(_frame(1, 14, 0, b"corrupt-me"))
    bad[-1] ^= 0xFF
    for data in (buf, buf + _frame(1, 13, 0, b"gamma")[:-2],
                 buf + bytes(bad), b"", buf[:7]):
        recs, end = native.wal_scan(data)
        assert (recs, end) == jnative.wal_scan(data)
    recs, end = native.wal_scan(buf + bytes(bad))
    assert [(r[2], r[3], r[4]) for r in recs] == [
        (1, 10, 0), (1, 11, 1), (2, 12, 0)]
    assert end == len(buf)
    off, plen = recs[1][0], recs[1][1]
    assert buf[off:off + plen] == b"beta!"


def _batches(n: int) -> list:
    schema = Schema([
        ColumnSchema("host", DataType.STRING, SemanticType.TAG),
        ColumnSchema("ts", DataType.TIMESTAMP_MILLISECOND,
                     SemanticType.TIMESTAMP, nullable=False),
        ColumnSchema("v", DataType.FLOAT64, SemanticType.FIELD)])
    rng = np.random.default_rng(5)
    return [RecordBatch(schema, {
        "host": DictVector.encode([f"h{int(i)}"
                                   for i in rng.integers(0, 4, 3)]),
        "ts": np.arange(3, dtype=np.int64) + 10 * seq,
        "v": rng.uniform(0, 1, 3)}) for seq in range(n)]


def _replay(root, use_native: bool, monkeypatch, from_seq=0):
    if not use_native:
        monkeypatch.setattr(wal_mod.native, "try_load", lambda: None)
    wal = Wal(str(root))
    try:
        entries = list(wal.replay(7, from_seq))
        sizes = sorted(os.path.getsize(os.path.join(root, f))
                       for f in os.listdir(root))
        return [(e.region_id, e.seq, e.op_type, e.batch.num_rows,
                 e.batch.columns["ts"].tolist(),
                 e.batch.columns["v"].tolist(),
                 e.batch.columns["host"].decode().tolist())
                for e in entries], sizes, wal.scanned_frames
    finally:
        monkeypatch.undo()
        wal.close()


@pytest.mark.parametrize("tail", ["clean", "torn", "corrupt"])
def test_wal_replay_same_with_and_without_native_scan(tmp_path, tail,
                                                      monkeypatch):
    """Entries and the truncation point do not depend on the route; the
    native route counts the frames it scanned."""
    roots = [tmp_path / "native", tmp_path / "python"]
    for root in roots:
        wal = Wal(str(root), segment_bytes=700)  # several segments
        for seq, batch in enumerate(_batches(8)):
            wal.append(7, seq, seq % 2, batch)
        wal.close()
        path = [p for p in sorted(os.path.join(root, f)
                                  for f in os.listdir(root))
                if os.path.getsize(p)][-1]
        with open(path, "r+b") as f:
            data = f.read()
            if tail == "torn":
                f.truncate(len(data) - 5)
            elif tail == "corrupt":
                f.seek(len(data) - 1)
                f.write(bytes([data[-1] ^ 0xFF]))
    got_native = _replay(roots[0], True, monkeypatch, from_seq=2)
    got_python = _replay(roots[1], False, monkeypatch, from_seq=2)
    assert got_native[:2] == got_python[:2]
    assert got_native[2] > 0 and got_python[2] == 0
    entries = got_native[0]
    want = 6 if tail == "clean" else 5
    assert [e[1] for e in entries] == list(range(2, 2 + want))
    # a second replay after the truncation reads the same entries
    assert _replay(roots[0], True, monkeypatch, 2)[0] == entries
    assert _replay(roots[1], False, monkeypatch, 2)[0] == entries
