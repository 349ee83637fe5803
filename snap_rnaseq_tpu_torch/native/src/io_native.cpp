// Native I/O runtime: BGZF codec + FASTQ scanner + base encoding.
//
// TPU-native equivalent of the reference's native I/O hot paths:
//   * GzipDataWriter.{h,cpp} (chunked BGZF/gzip compression for BAM/.gz)
//   * DataReader.cpp:651-930 (GzipDataReader: whole-batch zlib inflate)
//   * FASTQ.cpp record scanning + Tables.cpp base translation
//
// Exposed as a plain C ABI consumed via ctypes (native/__init__.py); every
// function is thread-safe and the compressors fan out over pthreads, the
// analog of the reference's multi-threaded GzipDataWriter filter.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <pthread.h>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// BGZF
// ---------------------------------------------------------------------------

static const int BGZF_BLOCK_SIZE = 0x10000 - 256;  // uncompressed bytes/block
static const int BGZF_MAX_COMP = 0x10000;          // worst-case block size

// one BGZF block: gzip stream with BC extra field carrying (BSIZE-1)
static int bgzf_compress_one(const uint8_t* in, int in_len, uint8_t* out,
                             int level) {
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    // windowBits=-15: raw deflate; we write the gzip wrapper ourselves
    if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                     Z_DEFAULT_STRATEGY) != Z_OK) return -1;
    uint8_t* body = out + 18;
    zs.next_in = (Bytef*)in;
    zs.avail_in = in_len;
    zs.next_out = (Bytef*)body;
    zs.avail_out = BGZF_MAX_COMP - 18 - 8;
    int r = deflate(&zs, Z_FINISH);
    deflateEnd(&zs);
    if (r != Z_STREAM_END) return -1;
    int clen = (int)zs.total_out;
    int bsize = clen + 18 + 8;
    // gzip header with BC extra subfield (SAM spec §4.1)
    static const uint8_t hdr[12] = {0x1f, 0x8b, 8, 4, 0, 0, 0, 0, 0, 0xff,
                                    6, 0};
    memcpy(out, hdr, 12);
    out[12] = 'B'; out[13] = 'C'; out[14] = 2; out[15] = 0;
    out[16] = (uint8_t)((bsize - 1) & 0xff);
    out[17] = (uint8_t)(((bsize - 1) >> 8) & 0xff);
    uint32_t crc = crc32(0, in, in_len);
    uint8_t* tail = body + clen;
    tail[0] = crc & 0xff; tail[1] = (crc >> 8) & 0xff;
    tail[2] = (crc >> 16) & 0xff; tail[3] = (crc >> 24) & 0xff;
    tail[4] = in_len & 0xff; tail[5] = (in_len >> 8) & 0xff;
    tail[6] = (in_len >> 16) & 0xff; tail[7] = (in_len >> 24) & 0xff;
    return bsize;
}

struct BgzfJob {
    const uint8_t* in;
    int64_t in_len;
    uint8_t* out;       // per-block staging: n_blocks * BGZF_MAX_COMP
    int* out_sizes;
    int level;
    int64_t n_blocks;
    int64_t next;       // shared work counter
    pthread_mutex_t lock;
    int failed;
};

static void* bgzf_worker(void* arg) {
    BgzfJob* job = (BgzfJob*)arg;
    for (;;) {
        pthread_mutex_lock(&job->lock);
        int64_t i = job->next++;
        pthread_mutex_unlock(&job->lock);
        if (i >= job->n_blocks || job->failed) return nullptr;
        int64_t off = i * (int64_t)BGZF_BLOCK_SIZE;
        int len = (int)((job->in_len - off < BGZF_BLOCK_SIZE)
                            ? job->in_len - off : BGZF_BLOCK_SIZE);
        int r = bgzf_compress_one(job->in + off, len,
                                  job->out + i * (int64_t)BGZF_MAX_COMP,
                                  job->level);
        if (r < 0) job->failed = 1;
        job->out_sizes[i] = r;
    }
}

// Compress `in_len` bytes into BGZF blocks using `n_threads` workers.
// out must hold ceil(in_len/BGZF_BLOCK_SIZE)*BGZF_MAX_COMP (+28 for EOF when
// add_eof). Returns total bytes written, or -1.
int64_t bgzf_compress(const uint8_t* in, int64_t in_len, uint8_t* out,
                      int level, int n_threads, int add_eof) {
    static const uint8_t EOF_BLOCK[28] = {
        0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00,
        0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0, 0, 0, 0,
        0, 0, 0, 0};
    int64_t n_blocks = (in_len + BGZF_BLOCK_SIZE - 1) / BGZF_BLOCK_SIZE;
    if (in_len == 0) n_blocks = 0;
    uint8_t* staging = (uint8_t*)malloc(n_blocks * (int64_t)BGZF_MAX_COMP);
    int* sizes = (int*)malloc(sizeof(int) * (n_blocks ? n_blocks : 1));
    if ((n_blocks && !staging) || !sizes) { free(staging); free(sizes); return -1; }

    BgzfJob job = {in, in_len, staging, sizes, level, n_blocks, 0,
                   PTHREAD_MUTEX_INITIALIZER, 0};
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 64) n_threads = 64;
    pthread_t threads[64];
    int nt = (int)(n_threads < n_blocks ? n_threads : n_blocks);
    for (int t = 0; t < nt; t++)
        pthread_create(&threads[t], nullptr, bgzf_worker, &job);
    for (int t = 0; t < nt; t++) pthread_join(threads[t], nullptr);

    int64_t total = 0;
    if (!job.failed) {
        for (int64_t i = 0; i < n_blocks; i++) {
            memcpy(out + total, staging + i * (int64_t)BGZF_MAX_COMP,
                   sizes[i]);
            total += sizes[i];
        }
        if (add_eof) {
            memcpy(out + total, EOF_BLOCK, 28);
            total += 28;
        }
    }
    free(staging);
    free(sizes);
    return job.failed ? -1 : total;
}

// Upper bound for bgzf_compress output.
int64_t bgzf_compress_bound(int64_t in_len) {
    int64_t n_blocks = (in_len + BGZF_BLOCK_SIZE - 1) / BGZF_BLOCK_SIZE;
    return n_blocks * (int64_t)BGZF_MAX_COMP + 28;
}

// Decompress a whole BGZF (or plain multi-member gzip) buffer.
// Returns bytes written to out, or -1 (out_cap too small => -2).
int64_t bgzf_decompress(const uint8_t* in, int64_t in_len, uint8_t* out,
                        int64_t out_cap) {
    int64_t in_off = 0, out_off = 0;
    while (in_off < in_len) {
        z_stream zs;
        memset(&zs, 0, sizeof(zs));
        if (inflateInit2(&zs, 15 + 16) != Z_OK) return -1;  // gzip wrapper
        zs.next_in = (Bytef*)(in + in_off);
        zs.avail_in = (uInt)(in_len - in_off);
        zs.next_out = (Bytef*)(out + out_off);
        zs.avail_out = (uInt)(out_cap - out_off);
        int r = inflate(&zs, Z_FINISH);
        int64_t consumed = (int64_t)(in_len - in_off) - zs.avail_in;
        out_off += (int64_t)zs.total_out;
        inflateEnd(&zs);
        if (r == Z_BUF_ERROR) return -2;
        if (r != Z_STREAM_END) return -1;
        in_off += consumed;
    }
    return out_off;
}

// ---------------------------------------------------------------------------
// FASTQ scanning
// ---------------------------------------------------------------------------

// Scan a buffer of complete FASTQ records; fill per-record
// (id_off, id_len, seq_off, seq_len, qual_off) int64 quintuples.
// Returns number of records parsed, or -1 on malformed input.
// trailing_off receives the offset of the first incomplete record.
int64_t fastq_scan(const uint8_t* buf, int64_t len, int64_t* rec,
                   int64_t max_rec, int64_t* trailing_off) {
    int64_t n = 0, pos = 0;
    while (pos < len && n < max_rec) {
        int64_t start = pos;
        if (buf[pos] != '@') return -1;
        int64_t id_off = pos + 1;
        while (pos < len && buf[pos] != '\n') pos++;
        if (pos >= len) { *trailing_off = start; return n; }
        int64_t id_end = (pos > id_off && buf[pos - 1] == '\r') ? pos - 1 : pos;
        pos++;
        int64_t seq_off = pos;
        while (pos < len && buf[pos] != '\n') pos++;
        if (pos >= len) { *trailing_off = start; return n; }
        int64_t seq_end = (pos > seq_off && buf[pos - 1] == '\r') ? pos - 1 : pos;
        pos++;
        if (pos >= len) { *trailing_off = start; return n; }
        if (buf[pos] != '+') return -1;
        while (pos < len && buf[pos] != '\n') pos++;
        if (pos >= len) { *trailing_off = start; return n; }
        pos++;
        int64_t qual_off = pos;
        int64_t seq_len = seq_end - seq_off;
        if (pos + seq_len > len) { *trailing_off = start; return n; }
        pos += seq_len;
        // allow \r\n after quality
        if (pos < len && buf[pos] == '\r') pos++;
        if (pos < len) {
            if (buf[pos] != '\n') return -1;
            pos++;
        }
        int64_t* r = rec + n * 5;
        r[0] = id_off; r[1] = id_end - id_off;
        r[2] = seq_off; r[3] = seq_len;
        r[4] = qual_off;
        n++;
    }
    *trailing_off = pos;
    return n;
}

// ---------------------------------------------------------------------------
// base translation (Tables.h:25-55 analog)
// ---------------------------------------------------------------------------

// ASCII -> code (A=0,G=1,C=2,T=3, everything else 4); vectorizable LUT loop.
void encode_bases(const uint8_t* in, int64_t len, uint8_t* out) {
    static uint8_t lut[256];
    static int init = 0;
    if (!init) {
        memset(lut, 4, 256);
        lut['A'] = 0; lut['a'] = 0;
        lut['G'] = 1; lut['g'] = 1;
        lut['C'] = 2; lut['c'] = 2;
        lut['T'] = 3; lut['t'] = 3;
        init = 1;
    }
    for (int64_t i = 0; i < len; i++) out[i] = lut[in[i]];
}

}  // extern "C"
