// Number text and row assembly for the CSV and ndjson writers
// (greptimedb_tpu_torch/datasource/text_writer.py), and the ndjson
// reader's cell scan (datasource/__init__.py::_read_ndjson_fast, at the
// end of this file).
//
// gtpu_number_text formats a whole float32 / float64 / int64 / uint64
// array into one byte buffer plus an offsets array, in one call. Floats
// come in two styles, each byte for byte the Python path's:
//
// - pyarrow's CSV text (kinds 0 and 1): the shortest round-trip digits
//   at the array's own precision (float32 shortest for float32),
//   positional when the decimal exponent is in [-7, 10), else
//   d[.ddd]e+X / e-X (no zero padding); nan, inf, -inf, -0; integral
//   values without ".0".
// - Python's repr of the double the value widens to (kinds 2 and 3, the
//   ndjson text): positional when the exponent is in [-4, 16), with
//   ".0" on integral values, else d[.ddd]e+XX (two digits at least);
//   NaN, Infinity, -Infinity as the JSON writer spells them.
//
// std::to_chars(scientific) gives the shortest digits of either width;
// its plain form picks whichever layout is shorter (100000.0 comes out
// as 1e+05), which matches neither style, so the layout is done here.
//
// gtpu_text_rows lays rows out from per-column texts: before each column
// a constant piece (a separator, or an ndjson key), after the last one
// the row's end. A column is an entries buffer with offsets and an
// optional int32 index (a dictionary's codes, or a NULL entry), so no
// Python object is made a value.
//
// ABI: plain extern "C", compiled with the other sources by
// greptimedb_tpu_torch/native/__init__.py; ctypes releases the GIL for
// each call. The two writers return the bytes written, or -1 when `cap`
// is short.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>

namespace {

// the widest text of one value: a sign, "0.", six zeros and 17 digits,
// or a sign, 17 digits, a point, "e-" and three exponent digits
constexpr int kMaxText = 32;

// shortest round-trip digits of a finite positive v into `digits` (no
// point, no trailing zeros) and its decimal exponent (v = d.ddd x 10^e)
template <typename T>
int shortest(T v, char* digits, int* e10) {
    char buf[64];
    auto r = std::to_chars(buf, buf + sizeof buf, v,
                           std::chars_format::scientific);
    const char* p = buf;
    int n = 0;
    for (; p < r.ptr && *p != 'e'; ++p)
        if (*p != '.') digits[n++] = *p;
    ++p;  // 'e'
    int sign = 1;
    if (*p == '-') {
        sign = -1;
        ++p;
    } else if (*p == '+') {
        ++p;
    }
    int e = 0;
    for (; p < r.ptr; ++p) e = e * 10 + (*p - '0');
    *e10 = sign * e;
    while (n > 1 && digits[n - 1] == '0') --n;
    return n;
}

char* put(char* o, const char* s, int n) {
    std::memcpy(o, s, n);
    return o + n;
}

char* zeros(char* o, int n) {
    for (int i = 0; i < n; ++i) *o++ = '0';
    return o;
}

char* put_int(char* o, int v, int min_digits) {
    char buf[8];
    auto r = std::to_chars(buf, buf + sizeof buf, v);
    int n = static_cast<int>(r.ptr - buf);
    o = zeros(o, min_digits - n);
    return put(o, buf, n);
}

// digits d[0..n) with the point after dp digits (dp may be <= 0 or > n)
char* positional(char* o, const char* d, int n, int dp, bool dot_zero) {
    if (dp <= 0) {
        o = put(o, "0.", 2);
        o = zeros(o, -dp);
        return put(o, d, n);
    }
    if (dp >= n) {
        o = put(o, d, n);
        o = zeros(o, dp - n);
        return dot_zero ? put(o, ".0", 2) : o;
    }
    o = put(o, d, dp);
    *o++ = '.';
    return put(o, d + dp, n - dp);
}

char* scientific(char* o, const char* d, int n, int e10, int exp_digits) {
    *o++ = d[0];
    if (n > 1) {
        *o++ = '.';
        o = put(o, d + 1, n - 1);
    }
    *o++ = 'e';
    *o++ = e10 < 0 ? '-' : '+';
    return put_int(o, e10 < 0 ? -e10 : e10, exp_digits);
}

template <typename T>
char* arrow_text(char* o, T v) {
    if (std::isnan(v)) return put(o, "nan", 3);
    if (std::signbit(v)) {
        *o++ = '-';
        v = -v;
    }
    if (std::isinf(v)) return put(o, "inf", 3);
    if (v == 0) return put(o, "0", 1);
    char d[kMaxText];
    int e10;
    int n = shortest(v, d, &e10);
    if (e10 > -7 && e10 < 10) return positional(o, d, n, e10 + 1, false);
    return scientific(o, d, n, e10, 1);
}

char* repr_text(char* o, double v) {
    if (std::isnan(v)) return put(o, "NaN", 3);
    if (std::signbit(v)) {
        if (std::isinf(v)) return put(o, "-Infinity", 9);
        *o++ = '-';
        v = -v;
    }
    if (std::isinf(v)) return put(o, "Infinity", 8);
    if (v == 0) return put(o, "0.0", 3);
    char d[kMaxText];
    int e10;
    int n = shortest(v, d, &e10);
    if (e10 >= -4 && e10 < 16) return positional(o, d, n, e10 + 1, true);
    return scientific(o, d, n, e10, 2);
}

template <typename T>
char* int_text(char* o, T v) {
    return std::to_chars(o, o + kMaxText, v).ptr;
}

}  // namespace

extern "C" {

// kind: 0 float32 / 1 float64 as pyarrow's CSV, 2 float32 / 3 float64 as
// Python's repr of the widened double, 4 int64, 5 uint64. offs gets n + 1
// entries (offs[0] = 0, value i is out[offs[i], offs[i + 1])).
long long gtpu_number_text(const void* vals, size_t n, int kind, char* out,
                           size_t cap, int64_t* offs) {
    char* o = out;
    offs[0] = 0;
    for (size_t i = 0; i < n; ++i) {
        if (static_cast<size_t>(o - out) + kMaxText > cap) return -1;
        switch (kind) {
            case 0: o = arrow_text(o, static_cast<const float*>(vals)[i]);
                break;
            case 1: o = arrow_text(o, static_cast<const double*>(vals)[i]);
                break;
            case 2: o = repr_text(o, static_cast<const float*>(vals)[i]);
                break;
            case 3: o = repr_text(o, static_cast<const double*>(vals)[i]);
                break;
            case 4: o = int_text(o, static_cast<const int64_t*>(vals)[i]);
                break;
            case 5: o = int_text(o, static_cast<const uint64_t*>(vals)[i]);
                break;
            default: return -1;
        }
        offs[i + 1] = o - out;
    }
    return o - out;
}

// Row r is pieces[0] col0(r) pieces[1] col1(r) ... col{k-1}(r) pieces[k],
// piece j being pieces_buf[piece_offs[j], piece_offs[j + 1]). Column j's
// text of row r is its entry e = index[j] ? index[j][r] : r, the bytes
// bufs[j][offs[j][e], offs[j][e + 1]).
long long gtpu_text_rows(size_t nrows, int ncols, const char* const* bufs,
                         const int64_t* const* offs,
                         const int32_t* const* index, const char* pieces_buf,
                         const int64_t* piece_offs, char* out, size_t cap) {
    char* o = out;
    const char* end = out + cap;
    for (size_t r = 0; r < nrows; ++r) {
        for (int j = 0; j <= ncols; ++j) {
            int64_t len = piece_offs[j + 1] - piece_offs[j];
            if (end - o < len) return -1;
            o = put(o, pieces_buf + piece_offs[j], static_cast<int>(len));
            if (j == ncols) break;
            int64_t e = index[j] ? index[j][r] : static_cast<int64_t>(r);
            int64_t a = offs[j][e], b = offs[j][e + 1];
            if (end - o < b - a) return -1;
            std::memcpy(o, bufs[j] + a, b - a);
            o += b - a;
        }
    }
    return o - out;
}

}  // extern "C"

// ---- ndjson columns ----------------------------------------------------------
//
// gtpu_ndjson_columns scans an ndjson body of the regular shape a writer
// emits (datasource/__init__.py::_read_ndjson_fast): every line one
// object with the expected keys in the expected order, each value a JSON
// number, a string without escapes or control bytes, true, false, null,
// or Python's NaN / Infinity / -Infinity. Per cell it records a kind and
// an int64 slot: the integer, the double's bits, 0 / 1, or the string's
// byte offset (its length in `lens`). A number reads as Python's json
// reads it: an integer literal is an int (past int64 the scan gives up),
// anything with a fraction or an exponent a double through from_chars,
// correctly rounded like float(). Anything else, a blank line or a '\r'
// included, returns -1 and the caller parses in Python; so does a row
// count other than `nrows`. Spaces and tabs may sit between tokens.

namespace {

enum : uint8_t { kNull = 0, kInt = 1, kFloat = 2, kBool = 3, kStr = 4 };

inline const char* ws(const char* p, const char* e) {
    while (p < e && (*p == ' ' || *p == '\t')) ++p;
    return p;
}

inline bool digit(char c) { return c >= '0' && c <= '9'; }

// one JSON value at p; false when it is outside the shape above
bool value(const char*& p, const char* e, const char* base, uint8_t* kind,
           int64_t* slot, uint32_t* len) {
    if (p >= e) return false;
    char c = *p;
    if (c == '"') {
        const char* s = ++p;
        while (p < e && *p != '"') {
            unsigned char b = static_cast<unsigned char>(*p);
            if (b == '\\' || b < 0x20) return false;
            ++p;
        }
        if (p >= e || p - s > 0xFFFFFFFFll) return false;
        *kind = kStr;
        *slot = s - base;
        *len = static_cast<uint32_t>(p - s);
        ++p;
        return true;
    }
    auto word = [&](const char* w, size_t n) {
        if (static_cast<size_t>(e - p) < n || std::memcmp(p, w, n) != 0)
            return false;
        p += n;
        return true;
    };
    if (c == 't' && word("true", 4)) { *kind = kBool; *slot = 1; return true; }
    if (c == 'f' && word("false", 5)) { *kind = kBool; *slot = 0; return true; }
    if (c == 'n' && word("null", 4)) { *kind = kNull; *slot = 0; return true; }
    double special = 0;
    bool is_special = false;
    if (c == 'N' && word("NaN", 3)) {
        special = std::nan(""), is_special = true;
    } else if (c == 'I' && word("Infinity", 8)) {
        special = HUGE_VAL, is_special = true;
    } else if (c == '-' && p + 1 < e && p[1] == 'I') {
        ++p;
        if (!word("Infinity", 8)) return false;
        special = -HUGE_VAL, is_special = true;
    }
    if (is_special) {
        *kind = kFloat;
        std::memcpy(slot, &special, sizeof special);
        return true;
    }
    // -?(0|[1-9][0-9]*)(\.[0-9]+)?([eE][+-]?[0-9]+)?, as json's scanner
    const char* s = p;
    if (p < e && *p == '-') ++p;
    if (p < e && *p == '0') {
        ++p;
    } else if (p < e && *p >= '1' && *p <= '9') {
        while (p < e && digit(*p)) ++p;
    } else {
        return false;
    }
    bool is_float = false;
    if (p + 1 < e && *p == '.' && digit(p[1])) {
        is_float = true;
        p += 2;
        while (p < e && digit(*p)) ++p;
    }
    if (p < e && (*p == 'e' || *p == 'E')) {
        const char* q = p + 1;
        if (q < e && (*q == '+' || *q == '-')) ++q;
        if (q < e && digit(*q)) {
            is_float = true;
            p = q;
            while (p < e && digit(*p)) ++p;
        }
    }
    if (is_float) {
        double d;
        auto r = std::from_chars(s, p, d);
        if (r.ec == std::errc::result_out_of_range) {
            // Python's float() gives +-inf past the range and +-0 under it
            d = std::strtod(std::string(s, p).c_str(), nullptr);
        } else if (r.ec != std::errc() || r.ptr != p) {
            return false;
        }
        *kind = kFloat;
        std::memcpy(slot, &d, sizeof d);
        return true;
    }
    int64_t v;
    auto r = std::from_chars(s, p, v);
    if (r.ec != std::errc() || r.ptr != p) return false;  // past int64
    *kind = kInt;
    *slot = v;
    return true;
}

}  // namespace

extern "C" {

// keys: the K expected keys' bytes back to back (key_lens[k] each), as
// they appear between the quotes. kinds / slots / lens are [K, nrows]
// (column-major by key). Returns nrows, or -1 outside the shape.
long long gtpu_ndjson_columns(const char* text, size_t n, int ncols,
                              const char* keys, const uint32_t* key_lens,
                              size_t nrows, uint8_t* kinds, int64_t* slots,
                              uint32_t* lens) {
    const char* p = text;
    const char* end = text + n;
    size_t row = 0;
    while (p < end) {
        if (row >= nrows) return -1;
        const char* eol = static_cast<const char*>(
            std::memchr(p, '\n', static_cast<size_t>(end - p)));
        if (eol == nullptr) eol = end;
        if (std::memchr(p, '\r', static_cast<size_t>(eol - p))) return -1;
        p = ws(p, eol);
        if (p >= eol || *p != '{') return -1;
        ++p;
        const char* key = keys;
        for (int k = 0; k < ncols; ++k) {
            p = ws(p, eol);
            if (k > 0) {
                if (p >= eol || *p != ',') return -1;
                p = ws(p + 1, eol);
            }
            uint32_t kl = key_lens[k];
            if (static_cast<size_t>(eol - p) < kl + 2u || *p != '"' ||
                std::memcmp(p + 1, key, kl) != 0 || p[kl + 1] != '"')
                return -1;
            p = ws(p + kl + 2, eol);
            key += kl;
            if (p >= eol || *p != ':') return -1;
            p = ws(p + 1, eol);
            size_t cell = static_cast<size_t>(k) * nrows + row;
            lens[cell] = 0;
            if (!value(p, eol, text, &kinds[cell], &slots[cell], &lens[cell]))
                return -1;
        }
        p = ws(p, eol);
        if (p >= eol || *p != '}') return -1;
        p = ws(p + 1, eol);
        if (p != eol) return -1;
        ++row;
        p = eol + 1;
    }
    return row == nrows ? static_cast<long long>(row) : -1;
}

}  // extern "C"
