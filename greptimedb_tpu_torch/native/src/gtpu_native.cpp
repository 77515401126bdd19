// Native runtime hot paths: snappy block codec + CRC32.
//
// The reference's runtime leans on native crates for exactly these
// (snap for Prometheus remote write/read bodies, crc32fast in the WAL
// framing — src/servers/src/prom_store.rs, src/log-store). The Python
// substrate keeps pure-Python fallbacks; this library is the fast path,
// loaded via ctypes (no pybind11 in the image).
//
// ABI: plain extern "C", buffers in / buffers out, negative return =
// error. Compiled by greptimedb_tpu_torch/native/__init__.py with
//   g++ -O3 -shared -fPIC
// at first use into greptimedb_tpu_torch/_build/.

#include <cstdint>
#include <cstring>
#include <cstddef>

extern "C" {

// ---------------------------------------------------------------- crc32
// IEEE polynomial (0xEDB88320), bit-identical to Python's zlib.crc32 —
// the WAL's on-disk frame checksum (storage/wal.py) must not change
// meaning between the Python and native paths.
static uint32_t CRC_TABLE[8][256];
static bool crc_init_done = false;

static void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        CRC_TABLE[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++)
        for (int s = 1; s < 8; s++)
            CRC_TABLE[s][i] =
                (CRC_TABLE[s - 1][i] >> 8) ^ CRC_TABLE[0][CRC_TABLE[s - 1][i] & 0xFF];
    crc_init_done = true;
}

uint32_t gtpu_crc32(const uint8_t* buf, size_t len, uint32_t seed) {
    if (!crc_init_done) crc_init();
    uint32_t c = seed ^ 0xFFFFFFFFu;
    // slice-by-8
    while (len >= 8) {
        c ^= (uint32_t)buf[0] | ((uint32_t)buf[1] << 8) |
             ((uint32_t)buf[2] << 16) | ((uint32_t)buf[3] << 24);
        uint32_t hi = (uint32_t)buf[4] | ((uint32_t)buf[5] << 8) |
                      ((uint32_t)buf[6] << 16) | ((uint32_t)buf[7] << 24);
        c = CRC_TABLE[7][c & 0xFF] ^ CRC_TABLE[6][(c >> 8) & 0xFF] ^
            CRC_TABLE[5][(c >> 16) & 0xFF] ^ CRC_TABLE[4][c >> 24] ^
            CRC_TABLE[3][hi & 0xFF] ^ CRC_TABLE[2][(hi >> 8) & 0xFF] ^
            CRC_TABLE[1][(hi >> 16) & 0xFF] ^ CRC_TABLE[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
    while (len--) c = CRC_TABLE[0][(c ^ *buf++) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// --------------------------------------------------------------- snappy
// Block format (https://github.com/google/snappy/blob/main/format_description.txt):
// varint uncompressed length, then literal / copy-1 / copy-2 / copy-4
// elements. Compression is the standard greedy 4-byte hash matcher.

static inline size_t put_varint(uint8_t* dst, uint64_t v) {
    size_t i = 0;
    while (v >= 0x80) { dst[i++] = (uint8_t)(v) | 0x80; v >>= 7; }
    dst[i++] = (uint8_t)v;
    return i;
}

static inline int get_varint(const uint8_t* src, size_t n, uint64_t* v) {
    uint64_t r = 0; int shift = 0; size_t i = 0;
    while (i < n) {
        uint8_t b = src[i++];
        r |= (uint64_t)(b & 0x7F) << shift;
        if (!(b & 0x80)) { *v = r; return (int)i; }
        shift += 7;
        if (shift > 35) return -1;
    }
    return -1;
}

size_t gtpu_snappy_max_compressed(size_t n) {
    return 32 + n + n / 6;
}

static inline uint32_t load32(const uint8_t* p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}

static inline size_t emit_literal(uint8_t* dst, const uint8_t* src, size_t len) {
    size_t o = 0;
    size_t l = len - 1;
    if (l < 60) {
        dst[o++] = (uint8_t)(l << 2);
    } else if (l < (1u << 8)) {
        dst[o++] = 60 << 2; dst[o++] = (uint8_t)l;
    } else if (l < (1u << 16)) {
        dst[o++] = 61 << 2; dst[o++] = (uint8_t)l; dst[o++] = (uint8_t)(l >> 8);
    } else if (l < (1u << 24)) {
        dst[o++] = 62 << 2; dst[o++] = (uint8_t)l; dst[o++] = (uint8_t)(l >> 8);
        dst[o++] = (uint8_t)(l >> 16);
    } else {
        dst[o++] = 63 << 2; dst[o++] = (uint8_t)l; dst[o++] = (uint8_t)(l >> 8);
        dst[o++] = (uint8_t)(l >> 16); dst[o++] = (uint8_t)(l >> 24);
    }
    memcpy(dst + o, src, len);
    return o + len;
}

static inline size_t emit_copy(uint8_t* dst, size_t offset, size_t len) {
    size_t o = 0;
    // prefer copy-1 (4..11 bytes, offset < 2048)
    while (len > 0) {
        if (len >= 4 && len <= 11 && offset < 2048) {
            dst[o++] = (uint8_t)(1 | ((len - 4) << 2) | ((offset >> 8) << 5));
            dst[o++] = (uint8_t)offset;
            return o;
        }
        size_t chunk = len > 64 ? 64 : len;  // copy-2/4 encode 1..64
        if (offset < (1u << 16)) {
            dst[o++] = (uint8_t)(2 | ((chunk - 1) << 2));
            dst[o++] = (uint8_t)offset; dst[o++] = (uint8_t)(offset >> 8);
        } else {
            dst[o++] = (uint8_t)(3 | ((chunk - 1) << 2));
            dst[o++] = (uint8_t)offset; dst[o++] = (uint8_t)(offset >> 8);
            dst[o++] = (uint8_t)(offset >> 16); dst[o++] = (uint8_t)(offset >> 24);
        }
        len -= chunk;
    }
    return o;
}

// returns compressed size, or -1 if dst too small (callers size with
// gtpu_snappy_max_compressed)
long long gtpu_snappy_compress(const uint8_t* src, size_t n,
                               uint8_t* dst, size_t dst_cap) {
    if (dst_cap < gtpu_snappy_max_compressed(n)) return -1;
    size_t o = put_varint(dst, n);
    if (n == 0) return (long long)o;

    const size_t HASH_BITS = 14;
    uint32_t table[1 << 14];
    memset(table, 0xFF, sizeof(table));

    size_t ip = 0;          // input position
    size_t lit_start = 0;   // start of pending literal run
    while (ip + 4 <= n) {
        uint32_t h = (load32(src + ip) * 0x1E35A7BDu) >> (32 - HASH_BITS);
        uint32_t cand = table[h];
        table[h] = (uint32_t)ip;
        if (cand != 0xFFFFFFFFu && cand < ip &&
            ip - cand < (1u << 16) &&  // keep offsets in copy-2 range
            load32(src + cand) == load32(src + ip)) {
            // extend the match
            size_t mlen = 4;
            while (ip + mlen < n && src[cand + mlen] == src[ip + mlen] &&
                   mlen < 0xFFFF)
                mlen++;
            if (ip > lit_start)
                o += emit_literal(dst + o, src + lit_start, ip - lit_start);
            o += emit_copy(dst + o, ip - cand, mlen);
            ip += mlen;
            lit_start = ip;
        } else {
            ip++;
        }
    }
    if (n > lit_start)
        o += emit_literal(dst + o, src + lit_start, n - lit_start);
    return (long long)o;
}

// returns uncompressed size, -1 on malformed input, -2 if dst too small
long long gtpu_snappy_uncompressed_length(const uint8_t* src, size_t n) {
    uint64_t len;
    if (get_varint(src, n, &len) < 0) return -1;
    return (long long)len;
}

long long gtpu_snappy_decompress(const uint8_t* src, size_t n,
                                 uint8_t* dst, size_t dst_cap) {
    uint64_t expect;
    int hdr = get_varint(src, n, &expect);
    if (hdr < 0) return -1;
    if (expect > dst_cap) return -2;
    size_t ip = (size_t)hdr, op = 0;
    while (ip < n) {
        uint8_t tag = src[ip++];
        uint32_t kind = tag & 3;
        if (kind == 0) {  // literal
            size_t len = (tag >> 2) + 1;
            if (len > 60) {
                size_t extra = len - 60;
                if (ip + extra > n) return -1;
                len = 0;
                for (size_t k = 0; k < extra; k++)
                    len |= (size_t)src[ip + k] << (8 * k);
                len += 1;
                ip += extra;
            }
            if (ip + len > n || op + len > expect) return -1;
            memcpy(dst + op, src + ip, len);
            ip += len; op += len;
            continue;
        }
        size_t len, offset;
        if (kind == 1) {
            len = ((tag >> 2) & 7) + 4;
            if (ip >= n) return -1;
            offset = ((size_t)(tag >> 5) << 8) | src[ip++];
        } else if (kind == 2) {
            len = (tag >> 2) + 1;
            if (ip + 2 > n) return -1;
            offset = (size_t)src[ip] | ((size_t)src[ip + 1] << 8);
            ip += 2;
        } else {
            len = (tag >> 2) + 1;
            if (ip + 4 > n) return -1;
            offset = (size_t)src[ip] | ((size_t)src[ip + 1] << 8) |
                     ((size_t)src[ip + 2] << 16) | ((size_t)src[ip + 3] << 24);
            ip += 4;
        }
        if (offset == 0 || offset > op || op + len > expect) return -1;
        // byte-wise: overlapping copies are the RLE idiom
        for (size_t k = 0; k < len; k++) dst[op + k] = dst[op + k - offset];
        op += len;
    }
    return op == expect ? (long long)op : -1;
}

// ------------------------------------------------------------- WAL scan
// Frame layout (storage/wal.py _HEADER "<IIQQB", packed):
//   u32 payload_len | u32 crc32(payload) | u64 region_id | u64 seq | u8 op
// One pass: validate every frame's bounds + checksum, emit the record
// table. Returns record count; *valid_end is the byte offset after the
// last intact frame (the torn-tail truncation point).
static inline uint32_t rd32(const uint8_t* p) {
    uint32_t v; memcpy(&v, p, 4); return v;
}
static inline uint64_t rd64(const uint8_t* p) {
    uint64_t v; memcpy(&v, p, 8); return v;
}

long long gtpu_wal_scan(const uint8_t* buf, size_t n,
                        uint64_t* payload_off, uint32_t* payload_len,
                        uint64_t* region_id, uint64_t* seq, uint8_t* op,
                        size_t max_records, uint64_t* valid_end) {
    const size_t HDR = 25;
    size_t pos = 0, cnt = 0;
    *valid_end = 0;
    while (pos + HDR <= n && cnt < max_records) {
        uint32_t plen = rd32(buf + pos);
        uint32_t crc = rd32(buf + pos + 4);
        if (pos + HDR + plen > n) break;                       // torn tail
        if (gtpu_crc32(buf + pos + HDR, plen, 0) != crc) break;  // corrupt
        payload_off[cnt] = pos + HDR;
        payload_len[cnt] = plen;
        region_id[cnt] = rd64(buf + pos + 8);
        seq[cnt] = rd64(buf + pos + 16);
        op[cnt] = buf[pos + 24];
        pos += HDR + plen;
        *valid_end = pos;
        cnt++;
    }
    return (long long)cnt;
}

}  // extern "C"
