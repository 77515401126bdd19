// Line-protocol column scan: the vector lane of servers/influx.py.
//
// One pass over a request body of the regular single-measurement shape
// (the whole Telegraf/TSBS stream): every line must be
//   <meas>,<tag0>=<v>,...,<tagT>=<v> <field0>=<x>,...,<fieldF>=<x>[ <ts>]
// with the first line's keys in the first line's order. Tag values come
// back as byte offsets and lengths, fields as doubles, timestamps as the
// raw integers. The scan never decides what the Python lanes would
// decide otherwise: anything outside a strict grammar that both lanes
// read the same way (backslashes, quotes, '#', control or non-ASCII
// bytes, an empty line, a misplaced separator, a value that is not a
// plain decimal, a non-finite value, a timestamp that is not a plain
// integer or leaves int64) returns -1 and the caller re-parses in
// Python. A plain decimal `[+-]?(d+[.d*]|.d+)([eE][+-]?d+)?` reads the
// same through std::from_chars (C++17: locale-free and correctly
// rounded) as through Python's float(); anything else Python accepts
// (underscores, "inf", "nan") falls to the Python lanes.
//
// ABI: plain extern "C", compiled with gtpu_native.cpp by
// greptimedb_tpu_torch/native/__init__.py. ctypes releases the GIL for
// the call, so request threads parse in parallel.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

static inline bool is_digit(char c) { return c >= '0' && c <= '9'; }

// strict decimal grammar over [p, e); true when it matches
static bool plain_decimal(const char* p, const char* e) {
    if (p < e && (*p == '+' || *p == '-')) p++;
    int digits = 0;
    while (p < e && is_digit(*p)) { p++; digits++; }
    if (p < e && *p == '.') {
        p++;
        while (p < e && is_digit(*p)) { p++; digits++; }
    }
    if (digits == 0) return false;
    if (p < e && (*p == 'e' || *p == 'E')) {
        p++;
        if (p < e && (*p == '+' || *p == '-')) p++;
        int exp_digits = 0;
        while (p < e && is_digit(*p)) { p++; exp_digits++; }
        if (exp_digits == 0) return false;
    }
    return p == e;
}

// Returns the row count, or -1 when the body leaves the lane's shape.
// keys: the tag keys then the field keys, concatenated; key_lens their
// lengths. Outputs are column-major: tag i of row r at i * max_rows + r.
long long gtpu_lp_columns(const char* buf, size_t n,
                          const char* meas, size_t meas_len,
                          const char* keys, const uint32_t* key_lens,
                          int ntags, int nfields, int has_ts,
                          size_t max_rows,
                          uint32_t* tag_off, uint32_t* tag_len,
                          double* fields, int64_t* ts) {
    for (size_t i = 0; i < n; i++) {
        unsigned char c = (unsigned char)buf[i];
        if ((c < 0x20 && c != '\n') || c >= 0x7F || c == '\\' || c == '"'
            || c == '#')
            return -1;
    }
    const char* end = buf + n;
    const char* p = buf;
    size_t row = 0;
    while (p < end) {
        if (row >= max_rows) return -1;
        if ((size_t)(end - p) < meas_len || memcmp(p, meas, meas_len) != 0)
            return -1;
        p += meas_len;
        const char* key = keys;
        for (int k = 0; k < ntags + nfields; k++) {
            // the separator before this key: ',' inside a section, ' '
            // opening the field section
            char sep = (k == ntags) ? ' ' : ',';
            if (p >= end || *p != sep) return -1;
            p++;
            uint32_t kl = key_lens[k];
            if ((size_t)(end - p) <= kl || memcmp(p, key, kl) != 0
                || p[kl] != '=')
                return -1;
            p += kl + 1;
            key += kl;
            const char* v = p;
            while (p < end && *p != ',' && *p != ' ' && *p != '\n') p++;
            if (k < ntags) {
                tag_off[(size_t)k * max_rows + row] = (uint32_t)(v - buf);
                tag_len[(size_t)k * max_rows + row] = (uint32_t)(p - v);
                continue;
            }
            if (!plain_decimal(v, p)) return -1;
            // from_chars takes no leading '+'
            const char* q = (*v == '+') ? v + 1 : v;
            double x = 0.0;
            auto r = std::from_chars(q, p, x);
            if (r.ec != std::errc() || r.ptr != p || !std::isfinite(x))
                return -1;
            fields[(size_t)(k - ntags) * max_rows + row] = x;
        }
        if (has_ts) {
            if (p >= end || *p != ' ') return -1;
            p++;
            const char* v = p;
            bool neg = false;
            if (p < end && (*p == '+' || *p == '-')) neg = *p++ == '-';
            const char* d = p;
            uint64_t mag = 0;
            while (p < end && is_digit(*p)) {
                uint64_t digit = (uint64_t)(*p - '0');
                if (mag > (UINT64_MAX - digit) / 10) return -1;
                mag = mag * 10 + digit;
                p++;
            }
            if (p == d || p == v) return -1;
            if (mag > (uint64_t)INT64_MAX + (neg ? 1u : 0u)) return -1;
            ts[row] = neg ? (int64_t)(0 - mag) : (int64_t)mag;
        }
        if (p < end) {
            if (*p != '\n' || p + 1 == end) return -1;
            p++;
        }
        row++;
    }
    return (long long)row;
}

}  // extern "C"
