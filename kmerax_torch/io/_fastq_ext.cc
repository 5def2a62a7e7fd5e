// Native FASTQ chunk parser + 2-bit base packing (SURVEY.md §2 #5).
//
// The reference overlaps parsing with compute via a C++ thread pool; here the
// hot per-byte work (record framing + base-code translation) runs in C++ while
// Python handles file/gzip streaming and hands whole chunks down. Loaded via
// ctypes (kmerax/io/native.py) — no pybind11 in this environment.
//
// Contract mirrors kmerax/io/fastq.py exactly: 4-line records, name line
// must start with '@', A/C/G/T (any case) -> 0..3, everything else -> 4.
//
// Build: g++ -O3 -march=native -shared -fPIC -o _fastq_ext.so _fastq_ext.cc

#include <cstdint>
#include <cstring>

namespace {

int8_t LUT[256];

struct LutInit {
    LutInit() {
        memset(LUT, 4, sizeof(LUT));
        LUT[(unsigned)'A'] = LUT[(unsigned)'a'] = 0;
        LUT[(unsigned)'C'] = LUT[(unsigned)'c'] = 1;
        LUT[(unsigned)'G'] = LUT[(unsigned)'g'] = 2;
        LUT[(unsigned)'T'] = LUT[(unsigned)'t'] = 3;
    }
} lut_init;

inline const uint8_t* find_nl(const uint8_t* p, const uint8_t* end) {
    return static_cast<const uint8_t*>(memchr(p, '\n', end - p));
}

}  // namespace

extern "C" {

// Parse complete records from buf[0:len] into caller-allocated arrays.
//   bases:   cap_records * max_len int8, padded with 4 past each read length
//   lengths: cap_records int32
//   name_off/name_len, qual_off/qual_len: byte ranges into buf (name without
//   the leading '@'; both without trailing newline)
//   plus_off/plus_len: byte range of the third ('+') separator line, kept
//   verbatim so '+name'-style records round-trip byte-identically
// Returns #records parsed (stops at cap_records or on an incomplete tail);
// *consumed = bytes consumed. Errors: -1 bad name line, -2 read > max_len.
long kmerax_fastq_parse(const uint8_t* buf, long len, long cap_records,
                        long max_len, int8_t* bases, int32_t* lengths,
                        int64_t* name_off, int32_t* name_len,
                        int64_t* qual_off, int32_t* qual_len,
                        int64_t* plus_off, int32_t* plus_len,
                        long* consumed) {
    const uint8_t* p = buf;
    const uint8_t* end = buf + len;
    long nrec = 0;
    *consumed = 0;
    while (nrec < cap_records) {
        const uint8_t* rec_start = p;
        if (p >= end) break;
        const uint8_t* nl1 = find_nl(p, end);
        if (!nl1) break;
        if (*p != '@') return -1;
        const uint8_t* nl2 = find_nl(nl1 + 1, end);
        if (!nl2) break;
        const uint8_t* nl3 = find_nl(nl2 + 1, end);
        if (!nl3) break;
        const uint8_t* nl4 = find_nl(nl3 + 1, end);
        if (!nl4) break;

        long seq_len = nl2 - (nl1 + 1);
        if (seq_len > max_len) return -2;
        name_off[nrec] = (p + 1) - buf;
        name_len[nrec] = (int32_t)(nl1 - (p + 1));
        plus_off[nrec] = (nl2 + 1) - buf;
        plus_len[nrec] = (int32_t)(nl3 - (nl2 + 1));
        qual_off[nrec] = (nl3 + 1) - buf;
        qual_len[nrec] = (int32_t)(nl4 - (nl3 + 1));
        int8_t* brow = bases + nrec * max_len;
        const uint8_t* s = nl1 + 1;
        long i = 0;
        for (; i < seq_len; ++i) brow[i] = LUT[s[i]];
        for (; i < max_len; ++i) brow[i] = 4;
        lengths[nrec] = (int32_t)seq_len;
        ++nrec;
        p = nl4 + 1;
        *consumed = p - buf;
        (void)rec_start;
    }
    return nrec;
}

// Reverse-complement a base-code array in place (codes 0..3; >=4 unchanged).
void kmerax_revcomp(int8_t* bases, long n) {
    for (long i = 0, j = n - 1; i < j; ++i, --j) {
        int8_t a = bases[i], b = bases[j];
        bases[i] = b < 4 ? (int8_t)(3 - b) : b;
        bases[j] = a < 4 ? (int8_t)(3 - a) : a;
    }
    if (n & 1) {
        int8_t c = bases[n / 2];
        if (c < 4) bases[n / 2] = (int8_t)(3 - c);
    }
}

// Base codes -> ASCII (4 -> 'N'), for the FASTQ writer hot path.
void kmerax_bases_to_ascii(const int8_t* bases, long n, uint8_t* out) {
    static const uint8_t CHR[5] = {'A', 'C', 'G', 'T', 'N'};
    for (long i = 0; i < n; ++i) {
        int8_t b = bases[i];
        out[i] = CHR[b > 4 ? 4 : b];
    }
}

}  // extern "C"
