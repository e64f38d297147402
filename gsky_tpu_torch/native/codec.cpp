// Native decoders for the GeoTIFF reader's hot path.
//
// TIFF-variant LZW, PackBits, and the horizontal (predictor 2) and
// floating-point (predictor 3) predictors, called through ctypes from
// gsky_tpu_torch/native/__init__.py, which builds this file with the
// host C++ compiler on first use (deflate stays with zlib).  The plain
// Python decoders in gsky_tpu_torch/io/geotiff.py compute the same
// bytes and are what the tests hold this library against.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// TIFF LZW: MSB-first codes, Clear=256, EOI=257, early code-width change.
// Returns bytes written, or -1 on corrupt input.
long lzw_decode(const uint8_t* src, long src_len, uint8_t* dst, long dst_len) {
    // table entries reference previous output: store (prev, first, len, tail)
    struct Entry { int32_t prev; uint8_t first; uint8_t tail; int32_t len; };
    std::vector<Entry> table(4096);
    for (int i = 0; i < 256; i++) {
        table[i] = {-1, (uint8_t)i, (uint8_t)i, 1};
    }
    int next_code = 258;
    int width = 9;
    long out = 0;
    long bitpos = 0;
    const long nbits = src_len * 8;
    int prev_code = -1;

    auto emit = [&](int code) -> bool {
        // write the expansion of `code` at dst+out (backwards fill);
        // per-byte `w < dst_len` guard below handles truncation
        long end = out + table[code].len;
        long w = end - 1;
        int c = code;
        while (c >= 0 && w >= out) {
            if (w < dst_len) dst[w] = table[c].tail;
            c = table[c].prev;
            w--;
        }
        out = end > dst_len ? dst_len : end;
        return true;
    };

    while (bitpos + width <= nbits && out < dst_len) {
        long byte0 = bitpos >> 3;
        uint32_t chunk = ((uint32_t)src[byte0] << 16);
        if (byte0 + 1 < src_len) chunk |= ((uint32_t)src[byte0 + 1] << 8);
        if (byte0 + 2 < src_len) chunk |= (uint32_t)src[byte0 + 2];
        int shift = 24 - (int)(bitpos & 7) - width;
        int code = (int)((chunk >> shift) & ((1u << width) - 1));
        bitpos += width;

        if (code == 256) {  // clear
            next_code = 258;
            width = 9;
            prev_code = -1;
            continue;
        }
        if (code == 257) break;  // EOI

        if (prev_code < 0) {
            if (code >= 256) return -1;
            emit(code);
            prev_code = code;
        } else {
            if (code < next_code) {
                // new entry: prev + first(code)
                if (next_code < 4096) {
                    table[next_code] = {prev_code, table[prev_code].first,
                                        table[code].first,
                                        table[prev_code].len + 1};
                    next_code++;
                }
                emit(code);
            } else if (code == next_code) {
                if (next_code >= 4096) return -1;
                table[next_code] = {prev_code, table[prev_code].first,
                                    table[prev_code].first,
                                    table[prev_code].len + 1};
                next_code++;
                emit(code);
            } else {
                return -1;
            }
            prev_code = code;
        }
        // early change
        if (next_code + 1 >= (1 << width) && width < 12) width++;
    }
    return out;
}

long packbits_decode(const uint8_t* src, long src_len, uint8_t* dst,
                     long dst_len) {
    long i = 0, out = 0;
    while (i < src_len && out < dst_len) {
        int8_t n = (int8_t)src[i++];
        if (n >= 0) {
            long cnt = n + 1;
            if (i + cnt > src_len) cnt = src_len - i;
            if (out + cnt > dst_len) cnt = dst_len - out;
            memcpy(dst + out, src + i, cnt);
            i += n + 1;
            out += cnt;
        } else if (n != -128) {
            long cnt = 1 - n;
            if (out + cnt > dst_len) cnt = dst_len - out;
            memset(dst + out, src[i], cnt);
            i++;
            out += cnt;
        }
    }
    return out;
}

// Horizontal predictor (TIFF predictor 2), in place.
// stride = cols*samples elements per row; sample-interleaved deltas.
void unpredict_h8(uint8_t* data, long rows, long cols, long samples) {
    long stride = cols * samples;
    for (long r = 0; r < rows; r++) {
        uint8_t* p = data + r * stride;
        for (long i = samples; i < stride; i++) p[i] += p[i - samples];
    }
}

void unpredict_h16(uint16_t* data, long rows, long cols, long samples) {
    long stride = cols * samples;
    for (long r = 0; r < rows; r++) {
        uint16_t* p = data + r * stride;
        for (long i = samples; i < stride; i++) p[i] += p[i - samples];
    }
}

void unpredict_h32(uint32_t* data, long rows, long cols, long samples) {
    long stride = cols * samples;
    for (long r = 0; r < rows; r++) {
        uint32_t* p = data + r * stride;
        for (long i = samples; i < stride; i++) p[i] += p[i - samples];
    }
}

// Floating-point predictor (TIFF predictor 3): byte rows are
// significance-plane separated (big-endian order) and delta-coded.
// in: raw row-major buffer rows x (cols*samples*itemsize) bytes
// out: native little-endian sample stream.
void unpredict_fp(const uint8_t* in, uint8_t* out, long rows, long cols,
                  long samples, long itemsize) {
    long rowlen = cols * samples * itemsize;
    long n = cols * samples;
    std::vector<uint8_t> acc(rowlen);
    for (long r = 0; r < rows; r++) {
        const uint8_t* src = in + r * rowlen;
        uint8_t* dstrow = out + r * rowlen;
        uint8_t run = 0;
        for (long i = 0; i < rowlen; i++) {
            run = (uint8_t)(run + src[i]);
            acc[i] = run;
        }
        // plane p holds byte p (big-endian); emit little-endian
        for (long e = 0; e < n; e++) {
            for (long b = 0; b < itemsize; b++) {
                dstrow[e * itemsize + b] = acc[(itemsize - 1 - b) * n + e];
            }
        }
    }
}

}  // extern "C"
