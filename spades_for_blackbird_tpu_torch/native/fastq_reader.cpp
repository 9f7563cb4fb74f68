// Native FASTA/FASTQ(.gz) -> 2-bit-code tensor ingest.
//
// The PyTorch port's host reader: its own copy of the JAX package's
// native/fastq_reader.cpp, the counterpart of the reference's C++ read
// streams (assembler/src/common/io/reads/fasta_fastq_gz_parser.hpp kseq
// parser + binary read store, io/reads/binary_converter.hpp:25). The hot
// loop parses gzipped FASTQ and packs bases straight into the padded
// uint8 code array the device consumes (A=0 C=1 G=2 T=3, 4 = N/padding):
// no intermediate strings, one malloc-free fill pass.
//
// Exposed as a C ABI for ctypes; native/__init__.py builds it at first
// use:  g++ -O3 -shared -fPIC fastq_reader.cpp -lz -o <build dir>/...so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <zlib.h>

namespace {

constexpr uint8_t kInvalid = 4;

struct CodeTable {
    uint8_t t[256];
    CodeTable() {
        memset(t, kInvalid, sizeof(t));
        t['A'] = t['a'] = 0;
        t['C'] = t['c'] = 1;
        t['G'] = t['g'] = 2;
        t['T'] = t['t'] = 3;
    }
};
const CodeTable kCodes;

class LineReader {
  public:
    explicit LineReader(const char* path)
        : f_(gzopen(path, "rb")), len_(0), pos_(0), eof_(false) {}
    ~LineReader() {
        if (f_) gzclose(f_);
    }
    bool ok() const { return f_ != nullptr; }

    // Returns pointer to the next line (no terminator), length in *n.
    // Returns nullptr at EOF. The pointer is valid until the next call.
    const char* next_line(int64_t* n) {
        line_.clear();
        while (true) {
            if (pos_ >= len_) {
                if (eof_) break;
                len_ = gzread(f_, buf_, sizeof(buf_));
                pos_ = 0;
                if (len_ <= 0) {
                    eof_ = true;
                    len_ = 0;
                    break;
                }
            }
            char* nl = static_cast<char*>(
                memchr(buf_ + pos_, '\n', len_ - pos_));
            if (nl) {
                line_.append(buf_ + pos_, nl - (buf_ + pos_));
                pos_ = (nl - buf_) + 1;
                break;
            }
            line_.append(buf_ + pos_, len_ - pos_);
            pos_ = len_;
        }
        if (line_.empty() && eof_ && pos_ >= len_) return nullptr;
        if (!line_.empty() && line_.back() == '\r') line_.pop_back();
        *n = static_cast<int64_t>(line_.size());
        return line_.data();
    }

  private:
    gzFile f_;
    char buf_[1 << 16];
    int64_t len_, pos_;
    bool eof_;
    std::string line_;
};

}  // namespace

extern "C" {

// Pass 1: count records and max sequence length.
// Returns number of reads, or -1 on error. Sets *max_len.
int64_t sfb_scan(const char* path, int64_t* max_len) {
    LineReader r(path);
    if (!r.ok()) return -1;
    int64_t n = 0, maxlen = 0, cur = 0, llen;
    const char* line = r.next_line(&llen);
    if (!line) {
        *max_len = 0;
        return 0;
    }
    if (line[0] == '>') {  // FASTA
        cur = 0;
        while ((line = r.next_line(&llen)) != nullptr) {
            if (llen > 0 && line[0] == '>') {
                if (cur > maxlen) maxlen = cur;
                cur = 0;
                ++n;
            } else {
                cur += llen;
            }
        }
        if (cur > maxlen) maxlen = cur;
        ++n;
    } else if (line[0] == '@') {  // FASTQ: 4-line records
        while (true) {
            line = r.next_line(&llen);  // sequence
            if (!line) break;
            if (llen > maxlen) maxlen = llen;
            ++n;
            if (!r.next_line(&llen)) break;  // '+'
            if (!r.next_line(&llen)) break;  // quality
            if (!r.next_line(&llen)) break;  // next header
        }
    } else {
        return -1;
    }
    *max_len = maxlen;
    return n;
}

// Pass 2: fill codes (R*L uint8, caller-allocated) and lengths (R int32).
// codes must be pre-sized; rows are padded with 4. Optionally fills
// quals (R*L uint8 phred+33 raw, may be null). Returns reads filled.
int64_t sfb_fill(const char* path, uint8_t* codes, int32_t* lengths,
                   uint8_t* quals, int64_t R, int64_t L) {
    LineReader r(path);
    if (!r.ok()) return -1;
    memset(codes, kInvalid, static_cast<size_t>(R) * L);
    if (quals) memset(quals, 0, static_cast<size_t>(R) * L);
    int64_t llen;
    const char* line = r.next_line(&llen);
    if (!line) return 0;
    int64_t row = 0;
    if (line[0] == '>') {
        int64_t col = 0;
        while ((line = r.next_line(&llen)) != nullptr) {
            if (llen > 0 && line[0] == '>') {
                if (row < R) lengths[row] = static_cast<int32_t>(col);
                ++row;
                col = 0;
                continue;
            }
            if (row < R) {
                uint8_t* dst = codes + row * L + col;
                for (int64_t i = 0; i < llen && col + i < L; ++i)
                    dst[i] = kCodes.t[static_cast<uint8_t>(line[i])];
            }
            col += llen;
        }
        if (row < R) lengths[row] = static_cast<int32_t>(col);
        ++row;
    } else if (line[0] == '@') {
        while (row < R) {
            line = r.next_line(&llen);  // sequence
            if (!line) break;
            int64_t n = llen < L ? llen : L;
            uint8_t* dst = codes + row * L;
            for (int64_t i = 0; i < n; ++i)
                dst[i] = kCodes.t[static_cast<uint8_t>(line[i])];
            lengths[row] = static_cast<int32_t>(n);
            if (!r.next_line(&llen)) { ++row; break; }  // '+'
            line = r.next_line(&llen);                  // quality
            if (quals && line) {
                int64_t qn = llen < L ? llen : L;
                memcpy(quals + row * L, line, qn);
            }
            ++row;
            if (!line) break;
            if (!r.next_line(&llen)) break;             // next header
        }
    } else {
        return -1;
    }
    return row;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Binary read store: FASTQ/FASTA(.gz) -> packed 2-bit on-disk chunks.
//
// Counterpart of the reference's binary read store
// (io/reads/binary_converter.hpp:25 BinaryWriter + read_converter.hpp:25
// ReadConverter): convert once, then re-stream any chunk cheaply without
// holding the whole dataset in RAM.
//
// Format (little-endian):
//   u64 magic 0x46425450'53544f52 ("FBTPSTOR")
//   u64 num_reads, u64 max_len, u64 chunk_reads, u64 index_offset
//   body: per read  u32 length + ceil(len/4) bytes of 2-bit codes
//         (invalid bases stored as 'A' bits + sidecar: one u8 run skipped
//          -- invalid positions are re-marked from length-trimmed reads;
//          rare Ns are acceptable as A in the store, matching the
//          reference's binary reads which also drop Ns)
//   index: u64 file offset of each chunk start (num_chunks entries)

#include <vector>

namespace {
constexpr uint64_t kMagic = 0x4642545053544f52ull;

struct StoreHeader {
    uint64_t magic, num_reads, max_len, chunk_reads, index_offset;
};
}  // namespace

extern "C" {

// Convert ';'-separated input files into one store. Returns num reads
// or -1 on error.
int64_t sfb_store_convert(const char* paths_joined,
                            const char* store_path,
                            int64_t chunk_reads) {
    FILE* out = fopen(store_path, "wb");
    if (!out) return -1;
    StoreHeader hdr = {kMagic, 0, 0, static_cast<uint64_t>(chunk_reads), 0};
    fwrite(&hdr, sizeof(hdr), 1, out);

    std::vector<uint64_t> index;
    std::string joined(paths_joined);
    size_t start = 0;
    uint64_t n_reads = 0, max_len = 0;
    std::vector<uint8_t> packed;
    while (start <= joined.size()) {
        size_t semi = joined.find(';', start);
        std::string path = joined.substr(
            start, semi == std::string::npos ? std::string::npos
                                             : semi - start);
        start = semi == std::string::npos ? joined.size() + 1 : semi + 1;
        if (path.empty()) continue;
        LineReader r(path.c_str());
        if (!r.ok()) { fclose(out); return -1; }
        int64_t llen;
        const char* line = r.next_line(&llen);
        if (!line) continue;
        bool fasta = line[0] == '>';
        std::string seq;
        auto emit = [&](const std::string& s) {
            if (n_reads % hdr.chunk_reads == 0)
                index.push_back(static_cast<uint64_t>(ftell(out)));
            uint32_t len = static_cast<uint32_t>(s.size());
            fwrite(&len, sizeof(len), 1, out);
            packed.assign((s.size() + 3) / 4, 0);
            for (size_t i = 0; i < s.size(); ++i) {
                uint8_t c = kCodes.t[static_cast<uint8_t>(s[i])];
                if (c > 3) c = 0;
                packed[i >> 2] |=
                    static_cast<uint8_t>(c << ((i & 3) * 2));
            }
            fwrite(packed.data(), 1, packed.size(), out);
            if (s.size() > max_len) max_len = s.size();
            ++n_reads;
        };
        if (fasta) {
            while ((line = r.next_line(&llen)) != nullptr) {
                if (llen > 0 && line[0] == '>') {
                    if (!seq.empty()) emit(seq);
                    seq.clear();
                } else {
                    seq.append(line, llen);
                }
            }
            if (!seq.empty()) emit(seq);
            seq.clear();
        } else {
            // FASTQ
            while (true) {
                line = r.next_line(&llen);            // sequence
                if (!line) break;
                emit(std::string(line, llen));
                if (!r.next_line(&llen)) break;       // '+'
                if (!r.next_line(&llen)) break;       // quality
                if (!r.next_line(&llen)) break;       // next header
            }
        }
    }
    hdr.num_reads = n_reads;
    hdr.max_len = max_len;
    hdr.index_offset = static_cast<uint64_t>(ftell(out));
    fwrite(index.data(), sizeof(uint64_t), index.size(), out);
    fseek(out, 0, SEEK_SET);
    fwrite(&hdr, sizeof(hdr), 1, out);
    fclose(out);
    return static_cast<int64_t>(n_reads);
}

// Store metadata. Returns 0 or -1.
int64_t sfb_store_info(const char* store_path, int64_t* num_reads,
                         int64_t* max_len, int64_t* chunk_reads) {
    FILE* f = fopen(store_path, "rb");
    if (!f) return -1;
    StoreHeader hdr;
    if (fread(&hdr, sizeof(hdr), 1, f) != 1 || hdr.magic != kMagic) {
        fclose(f);
        return -1;
    }
    fclose(f);
    *num_reads = static_cast<int64_t>(hdr.num_reads);
    *max_len = static_cast<int64_t>(hdr.max_len);
    *chunk_reads = static_cast<int64_t>(hdr.chunk_reads);
    return 0;
}

// Load chunk `chunk_idx` into caller-allocated codes (R*L u8, padded
// with 4) and lengths (R i32). Returns reads loaded or -1.
int64_t sfb_store_load_chunk(const char* store_path, int64_t chunk_idx,
                               uint8_t* codes, int32_t* lengths,
                               int64_t R, int64_t L) {
    FILE* f = fopen(store_path, "rb");
    if (!f) return -1;
    StoreHeader hdr;
    if (fread(&hdr, sizeof(hdr), 1, f) != 1 || hdr.magic != kMagic) {
        fclose(f);
        return -1;
    }
    uint64_t n_chunks =
        (hdr.num_reads + hdr.chunk_reads - 1) / hdr.chunk_reads;
    if (chunk_idx < 0 || static_cast<uint64_t>(chunk_idx) >= n_chunks) {
        fclose(f);
        return -1;
    }
    if (fseek(f, static_cast<long>(hdr.index_offset +
                                   sizeof(uint64_t) * chunk_idx),
              SEEK_SET) != 0) { fclose(f); return -1; }
    uint64_t off;
    if (fread(&off, sizeof(off), 1, f) != 1) { fclose(f); return -1; }
    fseek(f, static_cast<long>(off), SEEK_SET);

    uint64_t first = static_cast<uint64_t>(chunk_idx) * hdr.chunk_reads;
    uint64_t count = hdr.num_reads - first;
    if (count > hdr.chunk_reads) count = hdr.chunk_reads;
    if (static_cast<int64_t>(count) > R) count = static_cast<uint64_t>(R);

    memset(codes, kInvalid, static_cast<size_t>(R) * L);
    std::vector<uint8_t> packed;
    for (uint64_t r = 0; r < count; ++r) {
        uint32_t len;
        if (fread(&len, sizeof(len), 1, f) != 1) { fclose(f); return -1; }
        packed.resize((len + 3) / 4);
        if (!packed.empty() &&
            fread(packed.data(), 1, packed.size(), f) != packed.size()) {
            fclose(f);
            return -1;
        }
        uint32_t n = len < L ? len : static_cast<uint32_t>(L);
        uint8_t* dst = codes + r * L;
        for (uint32_t i = 0; i < n; ++i)
            dst[i] = (packed[i >> 2] >> ((i & 3) * 2)) & 3;
        lengths[r] = static_cast<int32_t>(n);
    }
    fclose(f);
    return static_cast<int64_t>(count);
}

}  // extern "C"
