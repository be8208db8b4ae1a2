// LZF block codec for PCD `binary_compressed` payloads.
//
// Reference parity: the reference recognizes the storage mode
// (io/pcd_pointcloud_io.cpp:936-937) but stubs the reader
// (`gotoNextBinaryCompressed` -> false, :516); we implement the actual
// codec so compressed clouds round-trip.  Format per the LZF stream spec:
// control byte < 32 starts a literal run of (ctrl+1) bytes; otherwise a
// back-reference of length (ctrl >> 5) + 2 (with an extension byte when the
// 3-bit length field saturates) at distance ((ctrl & 31) << 8 | next) + 1.

#include <cstdint>
#include <cstring>

extern "C" {

// returns decompressed size, or -1 on malformed input / overflow
long lzf_decompress(const uint8_t *in, long in_len, uint8_t *out,
                    long out_cap) {
    long ip = 0, op = 0;
    while (ip < in_len) {
        uint32_t ctrl = in[ip++];
        if (ctrl < 32) {            // literal run
            long len = ctrl + 1;
            if (ip + len > in_len || op + len > out_cap) return -1;
            std::memcpy(out + op, in + ip, len);
            ip += len;
            op += len;
        } else {                    // back reference
            long len = ctrl >> 5;
            if (len == 7) {
                if (ip >= in_len) return -1;
                len += in[ip++];
            }
            len += 2;
            if (ip >= in_len) return -1;
            long ref = op - (((ctrl & 0x1f) << 8) | in[ip++]) - 1;
            if (ref < 0 || op + len > out_cap) return -1;
            // byte-by-byte: references may overlap the output window
            for (long k = 0; k < len; k++) {
                out[op] = out[ref];
                op++;
                ref++;
            }
        }
    }
    return op;
}

// returns compressed size, or -1 when the output would not fit
long lzf_compress(const uint8_t *in, long in_len, uint8_t *out,
                  long out_cap) {
    const long HSIZE = 1 << 14;
    static thread_local long htab[1 << 14];
    for (long i = 0; i < HSIZE; i++) htab[i] = -1;

    long ip = 0, op = 0, lit_start = 0;

    auto flush_literals = [&](long end) -> bool {
        long pos = lit_start;
        while (pos < end) {
            long run = end - pos;
            if (run > 32) run = 32;
            if (op + 1 + run > out_cap) return false;
            out[op++] = (uint8_t)(run - 1);
            std::memcpy(out + op, in + pos, run);
            op += run;
            pos += run;
        }
        return true;
    };

    while (ip + 2 < in_len) {
        uint32_t seq = (in[ip] << 16) | (in[ip + 1] << 8) | in[ip + 2];
        long h = ((seq >> 4) ^ (seq << 3)) & (HSIZE - 1);
        long ref = htab[h];
        htab[h] = ip;
        long dist = ip - ref - 1;
        if (ref >= 0 && dist < (1 << 13)
                && in[ref] == in[ip] && in[ref + 1] == in[ip + 1]
                && in[ref + 2] == in[ip + 2]) {
            long len = 3;
            long maxlen = in_len - ip;
            if (maxlen > 264) maxlen = 264;  // 7 + 255 + 2
            while (len < maxlen && in[ref + len] == in[ip + len]) len++;
            if (!flush_literals(ip)) return -1;
            long lcode = len - 2;
            if (lcode < 7) {
                if (op + 2 > out_cap) return -1;
                out[op++] = (uint8_t)((lcode << 5) | (dist >> 8));
            } else {
                if (op + 3 > out_cap) return -1;
                out[op++] = (uint8_t)((7 << 5) | (dist >> 8));
                out[op++] = (uint8_t)(lcode - 7);
            }
            out[op++] = (uint8_t)(dist & 0xff);
            ip += len;
            lit_start = ip;
        } else {
            ip++;
        }
    }
    if (!flush_literals(in_len)) return -1;
    return op;
}

}  // extern "C"
