// Host serde kernels: the byte-shuffling loops of the SerializedPage
// codec (pack and unpack of non-null values, and the LZ4 block codec).
//
// Counterpart of presto_tpu/native/serde_kernels.cpp, trimmed to the
// calls the port makes, with the pack and unpack loops specialised by
// width (the same bytes). The reference's native worker serializes its
// pages in C++ (presto_cpp wraps Velox's PrestoSerializer);
// presto_tpu_torch/serde/pages.py
// calls these through ctypes (presto_tpu_torch/native/kernels.py), on
// the host, whatever device the query ran on.
//
// Build: presto_tpu_torch/native/kernels.py compiles this file at first
// use with the host C++ compiler (g++ -O3 -fPIC -shared -std=c++17)
// into presto_tpu_torch/build/, keyed by a hash of the source.

#include <cstdint>
#include <cstring>

namespace {

// The loops for one value width W, known when compiled, so that each
// copy is a single load and store. Pack writes every row and advances
// past the non-null ones only (no branch): `out` holds rows * W bytes.
template <int W>
int64_t pack_rows(const char* values, const uint8_t* nulls, int64_t rows,
                  char* out) {
    int64_t w = 0;
    for (int64_t i = 0; i < rows; ++i) {
        std::memcpy(out + w * W, values + i * W, W);
        w += !nulls[i];
    }
    return w;
}

template <int W>
void unpack_rows(const char* packed, const uint8_t* nulls, int64_t rows,
                 char* out) {
    int64_t r = 0;
    for (int64_t i = 0; i < rows; ++i) {
        if (nulls[i]) {
            std::memset(out + i * W, 0, W);
        } else {
            std::memcpy(out + i * W, packed + r * W, W);
            ++r;
        }
    }
}

}  // namespace

extern "C" {

// Copy the `width`-byte values of rows whose null flag is 0 into `out`
// (which holds rows * width bytes), densely. Returns the number of
// non-null rows.
int64_t pack_nonnull(const char* values, const uint8_t* nulls, int64_t rows,
                     int32_t width, char* out) {
    switch (width) {
        case 1: return pack_rows<1>(values, nulls, rows, out);
        case 2: return pack_rows<2>(values, nulls, rows, out);
        case 4: return pack_rows<4>(values, nulls, rows, out);
        case 8: return pack_rows<8>(values, nulls, rows, out);
    }
    int64_t w = 0;
    for (int64_t i = 0; i < rows; ++i) {
        if (!nulls[i]) {
            std::memcpy(out + w * width, values + i * width, width);
            ++w;
        }
    }
    return w;
}

// Inverse: spread `packed` (dense non-null values) to full row positions,
// zero-filling null slots.
void unpack_nonnull(const char* packed, const uint8_t* nulls, int64_t rows,
                    int32_t width, char* out) {
    switch (width) {
        case 1: return unpack_rows<1>(packed, nulls, rows, out);
        case 2: return unpack_rows<2>(packed, nulls, rows, out);
        case 4: return unpack_rows<4>(packed, nulls, rows, out);
        case 8: return unpack_rows<8>(packed, nulls, rows, out);
    }
    int64_t r = 0;
    for (int64_t i = 0; i < rows; ++i) {
        if (nulls[i]) {
            std::memset(out + i * width, 0, width);
        } else {
            std::memcpy(out + i * width, packed + r * width, width);
            ++r;
        }
    }
}

// ---------------------------------------------------------------------------
// LZ4 block format codec (the page compression the reference defaults
// to -- PagesSerdeFactory LZ4). Independent implementation of the
// public block format: [token: litlen<<4 | matchlen-4] [litlen ext]
// [literals] [offset u16le] [matchlen ext], last sequence literals-only.
// ---------------------------------------------------------------------------

static inline uint32_t lz4_hash(uint32_t v) {
    return (v * 2654435761u) >> 20;  // 12-bit table
}

// Compress src -> dst (dst must hold worst case: n + n/255 + 16).
// Returns compressed size, or -1 if dst_cap is too small.
int64_t lz4_compress(const uint8_t* src, int64_t n, uint8_t* dst,
                     int64_t dst_cap) {
    const int64_t MIN_END = 12;   // spec: last match must start 12+ from end
    int32_t table[4096];
    for (int i = 0; i < 4096; ++i) table[i] = -1;

    int64_t ip = 0, op = 0, anchor = 0;
    while (ip + 4 <= n - (MIN_END - 4) && ip + MIN_END <= n) {
        uint32_t word;
        std::memcpy(&word, src + ip, 4);
        uint32_t h = lz4_hash(word);
        int64_t cand = table[h];
        table[h] = (int32_t)ip;
        uint32_t cword;
        if (cand >= 0 && ip - cand <= 65535 &&
            (std::memcpy(&cword, src + cand, 4), cword == word)) {
            // extend match (not past n - 5)
            int64_t m = 4;
            int64_t limit = n - 5 - ip;
            while (m < limit && src[cand + m] == src[ip + m]) ++m;
            int64_t lit = ip - anchor;
            // emit token
            int64_t need = 1 + lit / 255 + 1 + lit + 2 + (m - 4) / 255 + 1;
            if (op + need > dst_cap) return -1;
            uint8_t tok_lit = lit >= 15 ? 15 : (uint8_t)lit;
            uint8_t tok_match = (m - 4) >= 15 ? 15 : (uint8_t)(m - 4);
            dst[op++] = (uint8_t)((tok_lit << 4) | tok_match);
            if (lit >= 15) {
                int64_t rest = lit - 15;
                while (rest >= 255) { dst[op++] = 255; rest -= 255; }
                dst[op++] = (uint8_t)rest;
            }
            std::memcpy(dst + op, src + anchor, lit);
            op += lit;
            uint16_t off = (uint16_t)(ip - cand);
            dst[op++] = (uint8_t)(off & 0xff);
            dst[op++] = (uint8_t)(off >> 8);
            if (m - 4 >= 15) {
                int64_t rest = m - 4 - 15;
                while (rest >= 255) { dst[op++] = 255; rest -= 255; }
                dst[op++] = (uint8_t)rest;
            }
            ip += m;
            anchor = ip;
        } else {
            ++ip;
        }
    }
    // final literals
    int64_t lit = n - anchor;
    int64_t need = 1 + lit / 255 + 1 + lit;
    if (op + need > dst_cap) return -1;
    uint8_t tok_lit = lit >= 15 ? 15 : (uint8_t)lit;
    dst[op++] = (uint8_t)(tok_lit << 4);
    if (lit >= 15) {
        int64_t rest = lit - 15;
        while (rest >= 255) { dst[op++] = 255; rest -= 255; }
        dst[op++] = (uint8_t)rest;
    }
    std::memcpy(dst + op, src + anchor, lit);
    op += lit;
    return op;
}

// Decompress src -> dst (exactly dst_len expected). Returns dst_len on
// success, -1 on malformed input.
int64_t lz4_decompress(const uint8_t* src, int64_t n, uint8_t* dst,
                       int64_t dst_len) {
    int64_t ip = 0, op = 0;
    while (ip < n) {
        uint8_t token = src[ip++];
        int64_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > n || op + lit > dst_len) return -1;
        std::memcpy(dst + op, src + ip, lit);
        ip += lit;
        op += lit;
        if (ip >= n) break;  // last sequence has no match part
        if (ip + 2 > n) return -1;
        int64_t off = src[ip] | (src[ip + 1] << 8);
        ip += 2;
        if (off == 0 || off > op) return -1;
        int64_t m = (token & 0xf) + 4;
        if (m - 4 == 15) { /* handled below */ }
        if ((token & 0xf) == 15) {
            uint8_t b;
            do {
                if (ip >= n) return -1;
                b = src[ip++];
                m += b;
            } while (b == 255);
        }
        if (op + m > dst_len) return -1;
        // byte-by-byte copy: offsets < match length must overlap-copy
        for (int64_t k = 0; k < m; ++k) {
            dst[op + k] = dst[op + k - off];
        }
        op += m;
    }
    return op == dst_len ? op : -1;
}

}  // extern "C"
