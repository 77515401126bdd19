"""HPACK, the header compression of HTTP/2 (RFC 7541), for the port's
gRPC transport (`servers/h2.py`): the static table, the dynamic table
with its size updates, integer and string literals, and the canonical
Huffman code of Appendix B (gRPC's C core Huffman-codes the base64 of
`-bin` metadata, the Flight token's among them, so the decoder must read
it).

Header names and values are `str` (latin-1, so every byte survives).
The encoder indexes exact static-table matches and sends everything
else as a literal without indexing: it never adds to the peer's dynamic
table, so the peer's SETTINGS_HEADER_TABLE_SIZE never binds it.
"""

from __future__ import annotations


class HpackError(ValueError):
    """A header block that is not valid HPACK (a COMPRESSION_ERROR)."""


STATIC_TABLE = (
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""),
    ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""),
    ("expires", ""), ("from", ""), ("host", ""), ("if-match", ""),
    ("if-modified-since", ""), ("if-none-match", ""), ("if-range", ""),
    ("if-unmodified-since", ""), ("last-modified", ""), ("link", ""),
    ("location", ""), ("max-forwards", ""), ("proxy-authenticate", ""),
    ("proxy-authorization", ""), ("range", ""), ("referer", ""),
    ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""),
    ("via", ""), ("www-authenticate", ""),
)
_STATIC_PAIR = {}
_STATIC_NAME = {}
for _i, (_n, _v) in enumerate(STATIC_TABLE, 1):
    _STATIC_PAIR.setdefault((_n, _v), _i)
    _STATIC_NAME.setdefault(_n, _i)

# ---- the Huffman code (Appendix B) --------------------------------------------

#: the code length in bits of each symbol 0..255 and EOS (256); the code
#: is canonical, so the lengths alone define it
_LENGTHS = bytes((
    13, 23, 28, 28, 28, 28, 28, 28, 28, 24, 30, 28, 28, 30, 28, 28,
    28, 28, 28, 28, 28, 28, 30, 28, 28, 28, 28, 28, 28, 28, 28, 28,
    6, 10, 10, 12, 13, 6, 8, 11, 10, 10, 8, 11, 8, 6, 6, 6,
    5, 5, 5, 6, 6, 6, 6, 6, 6, 6, 7, 8, 15, 6, 12, 10,
    13, 6, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7,
    7, 7, 7, 7, 7, 7, 7, 7, 8, 7, 8, 13, 19, 13, 14, 6,
    15, 5, 6, 5, 6, 5, 6, 6, 6, 5, 7, 7, 6, 6, 6, 5,
    6, 7, 6, 5, 5, 6, 7, 7, 7, 7, 7, 15, 11, 14, 13, 28,
    20, 22, 20, 20, 22, 22, 22, 23, 22, 23, 23, 23, 23, 23, 24, 23,
    24, 24, 22, 23, 24, 23, 23, 23, 23, 21, 22, 23, 22, 23, 23, 24,
    22, 21, 20, 22, 22, 23, 23, 21, 23, 22, 22, 24, 21, 22, 23, 23,
    21, 21, 22, 21, 23, 22, 23, 23, 20, 22, 22, 22, 23, 22, 22, 23,
    26, 26, 20, 19, 22, 23, 22, 25, 26, 26, 26, 27, 27, 26, 24, 25,
    19, 21, 26, 27, 27, 26, 27, 24, 21, 21, 26, 26, 28, 27, 27, 27,
    20, 24, 20, 21, 22, 21, 21, 23, 22, 22, 25, 25, 24, 24, 26, 23,
    26, 27, 26, 26, 27, 27, 27, 27, 27, 28, 27, 27, 27, 27, 27, 26,
    30,
))
EOS = 256


def _canonical_codes(lengths: bytes) -> list[int]:
    codes = [0] * len(lengths)
    order = sorted(range(len(lengths)), key=lambda s: (lengths[s], s))
    code, prev = 0, lengths[order[0]]
    for j, s in enumerate(order):
        if j:
            code = (code + 1) << (lengths[s] - prev)
        prev = lengths[s]
        codes[s] = code
    return codes


_CODES = _canonical_codes(_LENGTHS)
_DECODE = {(_LENGTHS[s], c): s for s, c in enumerate(_CODES)}
_MIN_LEN = min(_LENGTHS)


def huffman_encode(raw: bytes) -> bytes:
    acc = nbits = 0
    for b in raw:
        acc = (acc << _LENGTHS[b]) | _CODES[b]
        nbits += _LENGTHS[b]
    pad = (-nbits) % 8
    acc = (acc << pad) | ((1 << pad) - 1)  # the EOS prefix pads
    return (acc.to_bytes((nbits + pad) // 8, "big")
            if nbits + pad else b"")


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code = length = 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            length += 1
            if length < _MIN_LEN:
                continue
            sym = _DECODE.get((length, code))
            if sym is None:
                if length > 30:
                    raise HpackError("Huffman code longer than 30 bits")
                continue
            if sym == EOS:
                raise HpackError("EOS inside a Huffman string")
            out.append(sym)
            code = length = 0
    if length > 7 or code != (1 << length) - 1:
        raise HpackError("Huffman padding is not an EOS prefix")
    return bytes(out)


# ---- integers and strings -----------------------------------------------------


def encode_int(value: int, prefix_bits: int, first: int = 0) -> bytes:
    """`value` with an N-bit prefix; `first` holds the bits above it."""
    limit = (1 << prefix_bits) - 1
    if value < limit:
        return bytes((first | value,))
    out = bytearray((first | limit,))
    value -= limit
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_int(data, pos: int, prefix_bits: int) -> tuple[int, int]:
    if pos >= len(data):
        raise HpackError("header block cut inside an integer")
    limit = (1 << prefix_bits) - 1
    value = data[pos] & limit
    pos += 1
    if value < limit:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data):
            raise HpackError("header block cut inside an integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if shift > 63:
            raise HpackError("integer past 2^63")
        if not b & 0x80:
            return value, pos


def encode_str(s: str, huffman: bool = False) -> bytes:
    raw = s.encode("latin-1")
    if huffman:
        coded = huffman_encode(raw)
        return encode_int(len(coded), 7, 0x80) + coded
    return encode_int(len(raw), 7) + raw


def decode_str(data, pos: int) -> tuple[str, int]:
    if pos >= len(data):
        raise HpackError("header block cut before a string")
    huff = data[pos] & 0x80
    n, pos = decode_int(data, pos, 7)
    if pos + n > len(data):
        raise HpackError("string runs past the header block")
    raw = bytes(data[pos:pos + n])
    if huff:
        raw = huffman_decode(raw)
    return raw.decode("latin-1"), pos + n


# ---- the coder ---------------------------------------------------------------


def _entry_size(name: str, value: str) -> int:
    return len(name) + len(value) + 32


class Decoder:
    """Decodes header blocks in order, keeping the dynamic table. Its
    size limit is the SETTINGS_HEADER_TABLE_SIZE this side advertised."""

    def __init__(self, max_table_size: int = 4096):
        self.settings_max = max_table_size
        self.max_size = max_table_size
        self.table: list[tuple[str, str]] = []  # newest first
        self.size = 0

    def _evict(self) -> None:
        while self.size > self.max_size and self.table:
            n, v = self.table.pop()
            self.size -= _entry_size(n, v)

    def _add(self, name: str, value: str) -> None:
        self.table.insert(0, (name, value))
        self.size += _entry_size(name, value)
        self._evict()

    def _get(self, index: int) -> tuple[str, str]:
        if index <= 0:
            raise HpackError("header index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if i >= len(self.table):
            raise HpackError(f"header index {index} past the tables")
        return self.table[i]

    def decode(self, block) -> list[tuple[str, str]]:
        out = []
        pos = 0
        n = len(block)
        while pos < n:
            b = block[pos]
            if b & 0x80:  # indexed
                idx, pos = decode_int(block, pos, 7)
                out.append(self._get(idx))
            elif b & 0x40:  # literal with incremental indexing
                name, value, pos = self._literal(block, pos, 6)
                self._add(name, value)
                out.append((name, value))
            elif b & 0x20:  # dynamic table size update
                size, pos = decode_int(block, pos, 5)
                if size > self.settings_max:
                    raise HpackError(f"table size {size} past the "
                                     f"advertised {self.settings_max}")
                self.max_size = size
                self._evict()
            else:  # literal without indexing / never indexed
                name, value, pos = self._literal(block, pos, 4)
                out.append((name, value))
        return out

    def _literal(self, block, pos: int, prefix: int) -> tuple[str, str, int]:
        idx, pos = decode_int(block, pos, prefix)
        if idx:
            name = self._get(idx)[0]
        else:
            name, pos = decode_str(block, pos)
        value, pos = decode_str(block, pos)
        return name, value, pos


class Encoder:
    """Static-table indexing and literals without indexing; Huffman
    coding where it is shorter."""

    def encode(self, headers) -> bytes:
        out = bytearray()
        for name, value in headers:
            idx = _STATIC_PAIR.get((name, value))
            if idx:
                out += encode_int(idx, 7, 0x80)
                continue
            nidx = _STATIC_NAME.get(name, 0)
            out += encode_int(nidx, 4, 0x00)
            if not nidx:
                out += _shortest(name)
            out += _shortest(value)
        return bytes(out)


def _shortest(s: str) -> bytes:
    raw = s.encode("latin-1")
    nbits = sum(_LENGTHS[b] for b in raw)
    return encode_str(s, huffman=(nbits + 7) // 8 < len(raw))
