// hail_tpu native kernels: parallel BGZF decompression + fast VCF GT parse.
//
// TPU-native analogue of the reference's host-side native layer: the
// seekable block-gzip codec (`hail/hail/src/java/is/hail/io/compress/
// BGzipInputStream.java`) and the hot VCF parse loop
// (`is/hail/io/vcf/LoadVCF.scala:224-1311`) — the pieces that keep the
// chips fed (SURVEY §7 "host I/O throughput"). Compiled on first use via
// g++ (see native/__init__.py) and called through ctypes.
//
// Exposed C ABI:
//   bgzf_decompress(data, len, out, out_cap, n_threads) -> ssize_t written
//   bgzf_uncompressed_size(data, len) -> ssize_t
//   vcf_parse_gt(text, len, n_samples, contig_out...*) — see python wrapper
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <thread>
#include <atomic>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// BGZF: gzip members with BSIZE in the extra field; virtual offsets =
// (compressed_offset << 16) | within_block_offset.
// ---------------------------------------------------------------------------

struct BgzfBlock {
    size_t in_off;
    size_t in_len;
    size_t out_off;
    size_t out_len;
};

static int scan_blocks(const uint8_t* data, size_t len, std::vector<BgzfBlock>& blocks) {
    size_t pos = 0;
    size_t out_off = 0;
    while (pos + 18 <= len) {
        if (data[pos] != 0x1f || data[pos + 1] != 0x8b) return -1;
        uint16_t xlen = (uint16_t)(data[pos + 10] | (data[pos + 11] << 8));
        size_t extra = pos + 12;
        size_t extra_end = extra + xlen;
        if (extra_end > len) return -1;
        size_t bsize = 0;
        while (extra + 4 <= extra_end) {
            uint8_t si1 = data[extra], si2 = data[extra + 1];
            uint16_t slen = (uint16_t)(data[extra + 2] | (data[extra + 3] << 8));
            if (si1 == 66 && si2 == 67 && slen == 2) {
                bsize = (size_t)(data[extra + 4] | (data[extra + 5] << 8)) + 1;
            }
            extra += 4 + slen;
        }
        if (bsize == 0) return -2;  // plain gzip member, not BGZF
        if (pos + bsize > len) break;
        // ISIZE: last 4 bytes of the member
        size_t isize_off = pos + bsize - 4;
        uint32_t isize = (uint32_t)(data[isize_off] | (data[isize_off + 1] << 8)
                                    | (data[isize_off + 2] << 16) | ((uint32_t)data[isize_off + 3] << 24));
        blocks.push_back({pos, bsize, out_off, isize});
        out_off += isize;
        pos += bsize;
        if (isize == 0 && bsize == 28) break;  // EOF marker block
    }
    return 0;
}

long long bgzf_uncompressed_size(const uint8_t* data, size_t len) {
    std::vector<BgzfBlock> blocks;
    int rc = scan_blocks(data, len, blocks);
    if (rc != 0) return rc;
    size_t total = 0;
    for (auto& b : blocks) total += b.out_len;
    return (long long)total;
}

static void inflate_block(const uint8_t* data, const BgzfBlock& b, uint8_t* out) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    inflateInit2(&zs, 15 + 16);  // gzip wrapper
    zs.next_in = const_cast<uint8_t*>(data + b.in_off);
    zs.avail_in = (uInt)b.in_len;
    zs.next_out = out + b.out_off;
    zs.avail_out = (uInt)b.out_len;
    inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
}

long long bgzf_decompress(const uint8_t* data, size_t len, uint8_t* out,
                          size_t out_cap, int n_threads) {
    std::vector<BgzfBlock> blocks;
    int rc = scan_blocks(data, len, blocks);
    if (rc != 0) return rc;
    size_t total = 0;
    for (auto& b : blocks) total += b.out_len;
    if (total > out_cap) return -3;
    if (n_threads < 1) n_threads = 1;
    if ((size_t)n_threads > blocks.size()) n_threads = (int)(blocks.size() ? blocks.size() : 1);
    std::atomic<size_t> next(0);
    auto worker = [&]() {
        for (;;) {
            size_t i = next.fetch_add(1);
            if (i >= blocks.size()) break;
            inflate_block(data, blocks[i], out);
        }
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < n_threads; t++) threads.emplace_back(worker);
    worker();
    for (auto& t : threads) t.join();
    return (long long)total;
}

// virtual-offset index: per block (compressed_offset, uncompressed_offset)
long long bgzf_block_table(const uint8_t* data, size_t len,
                           unsigned long long* in_offs, unsigned long long* out_offs,
                           size_t cap) {
    std::vector<BgzfBlock> blocks;
    int rc = scan_blocks(data, len, blocks);
    if (rc != 0) return rc;
    size_t n = blocks.size() < cap ? blocks.size() : cap;
    for (size_t i = 0; i < n; i++) {
        in_offs[i] = blocks[i].in_off;
        out_offs[i] = blocks[i].out_off;
    }
    return (long long)blocks.size();
}

// ---------------------------------------------------------------------------
// Fast VCF GT parse: one pass over the (uncompressed) text body.
// For each data line, extracts CHROM (interned index into caller-provided
// ordered contig list is done python-side — here we emit line/field offsets),
// POS, and per-sample packed GT into preallocated arrays.
//
// Packing matches hail_tpu.genetics.call: ploidy|phased<<2|j<<3|k<<17.
// missing GT -> gt_out = -1.
// ---------------------------------------------------------------------------

static inline int parse_int_field(const char* p, const char* end, long* out) {
    long v = 0;
    const char* q = p;
    while (q < end && *q >= '0' && *q <= '9') { v = v * 10 + (*q - '0'); q++; }
    *out = v;
    return (int)(q - p);
}

long long vcf_parse_gt(const char* text, size_t len, long n_samples,
                       long max_lines,
                       long* line_start_out,    // [max_lines] offset of CHROM
                       long* contig_len_out,    // [max_lines] CHROM length
                       long* pos_out,           // [max_lines]
                       int32_t* gt_out          // [max_lines * n_samples]
                       ) {
    size_t pos = 0;
    long line_i = 0;
    while (pos < len && line_i < max_lines) {
        if (text[pos] == '#') {  // header line: skip
            while (pos < len && text[pos] != '\n') pos++;
            pos++;
            continue;
        }
        size_t line_start = pos;
        // CHROM
        size_t f0 = pos;
        while (pos < len && text[pos] != '\t') pos++;
        line_start_out[line_i] = (long)f0;
        contig_len_out[line_i] = (long)(pos - f0);
        if (pos >= len) break;
        pos++;  // tab
        // POS
        long p = 0;
        pos += parse_int_field(text + pos, text + len, &p);
        pos_out[line_i] = p;
        // skip ID REF ALT QUAL FILTER INFO FORMAT (7 tabs)
        int tabs = 0;
        while (pos < len && tabs < 8) {
            if (text[pos] == '\t') tabs++;
            else if (text[pos] == '\n') break;
            pos++;
        }
        // samples: GT is the first colon-separated field
        int32_t* row = gt_out + (size_t)line_i * n_samples;
        long s = 0;
        while (pos < len && text[pos] != '\n' && s < n_samples) {
            // parse GT at text[pos..]
            char c0 = text[pos];
            int32_t packed = -1;
            if (c0 != '.') {
                long a1 = 0;
                int n1 = parse_int_field(text + pos, text + len, &a1);
                if (n1 > 0) {
                    size_t q = pos + n1;
                    if (q < len && (text[q] == '/' || text[q] == '|')) {
                        int phased = text[q] == '|';
                        q++;
                        if (q < len && text[q] == '.') {
                            packed = -1;
                        } else {
                            long a2 = 0;
                            int n2 = parse_int_field(text + q, text + len, &a2);
                            if (n2 > 0) {
                                if (!phased && a2 < a1) {
                                    // unphased diploid normalized j <= k
                                    // (Genotype.diploidGtIndexWithSwap)
                                    long t = a1; a1 = a2; a2 = t;
                                }
                                packed = (int32_t)(2 | (phased ? 4 : 0) | (a1 << 3) | (a2 << 17));
                            }
                        }
                    } else {
                        // haploid
                        packed = (int32_t)(1 | (a1 << 3));
                    }
                }
            }
            row[s++] = packed;
            // advance to next sample (tab) or end of line
            while (pos < len && text[pos] != '\t' && text[pos] != '\n') pos++;
            if (pos < len && text[pos] == '\t') pos++;
        }
        while (s < n_samples) row[s++] = -1;
        while (pos < len && text[pos] != '\n') pos++;
        pos++;
        line_i++;
    }
    return line_i;
}

}  // extern "C"
