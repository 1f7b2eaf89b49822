// recordio: chunked record container with CRC32 integrity + skip-on-corrupt.
//
// The port's copy of paddle_tpu/native_src/recordio.cc.
// Native parity with the reference's recordio library
// (paddle/fluid/recordio/{header,chunk,scanner,writer}.h):
// records are grouped into chunks, each chunk framed as
//   [magic u32][num_records u32][payload_len u32][crc32 u32]
//   [u32 len][bytes]*num_records
// A corrupt chunk (bad CRC / truncation) is skipped, not fatal — the
// "fault-tolerant writing" capability from the reference's README. Exposed
// to Python through the C API at the bottom (ctypes, no pybind11 in image).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace recordio {

constexpr uint32_t kMagic = 0x7061646cu;  // "padl"

// ---- crc32 (IEEE, table-driven) ----
// function-local static: C++11 guarantees thread-safe one-time init
// (prefetch worker threads compute CRCs concurrently)
static const uint32_t* CrcTable() {
  static const struct Table {
    uint32_t v[256];
    Table() {
      for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k)
          c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        v[i] = c;
      }
    }
  } table;
  return table.v;
}

static uint32_t Crc32(const uint8_t* buf, size_t len) {
  const uint32_t* crc_table = CrcTable();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; ++i)
    c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

class Writer {
 public:
  Writer(const char* path, uint32_t max_chunk_records)
      : f_(fopen(path, "wb")), max_records_(max_chunk_records) {}
  ~Writer() { Close(); }

  bool ok() const { return f_ != nullptr; }

  void Write(const uint8_t* data, uint32_t len) {
    uint32_t l = len;
    payload_.insert(payload_.end(), reinterpret_cast<uint8_t*>(&l),
                    reinterpret_cast<uint8_t*>(&l) + 4);
    payload_.insert(payload_.end(), data, data + len);
    ++n_records_;
    if (n_records_ >= max_records_) Flush();
  }

  void Flush() {
    if (!f_ || n_records_ == 0) return;
    uint32_t header[4] = {kMagic, n_records_,
                          static_cast<uint32_t>(payload_.size()),
                          Crc32(payload_.data(), payload_.size())};
    if (fwrite(header, sizeof(header), 1, f_) != 1 ||
        fwrite(payload_.data(), 1, payload_.size(), f_) != payload_.size())
      error_ = true;  // e.g. disk full — surfaced via Close status
    payload_.clear();
    n_records_ = 0;
  }

  // returns false if any write failed (caller must treat the file as bad)
  bool Close() {
    bool ok = true;
    if (f_) {
      Flush();
      if (fclose(f_) != 0) error_ = true;
      f_ = nullptr;
      ok = !error_;
    }
    return ok;
  }

 private:
  FILE* f_;
  uint32_t max_records_;
  uint32_t n_records_ = 0;
  bool error_ = false;
  std::vector<uint8_t> payload_;
};

class Reader {
 public:
  explicit Reader(const char* path) : f_(fopen(path, "rb")) {}
  ~Reader() {
    if (f_) fclose(f_);
  }
  bool ok() const { return f_ != nullptr; }

  // peek the next record without consuming; returns nullptr at EOF.
  // Corrupt chunks are skipped.
  const std::string* Peek() {
    while (idx_ >= records_.size()) {
      if (!LoadChunk()) return nullptr;
    }
    return &records_[idx_];
  }

  void Consume() { ++idx_; }

  bool Next(std::string* out) {
    const std::string* r = Peek();
    if (!r) return false;
    *out = *r;
    Consume();
    return true;
  }

 private:
  // A corrupt header can carry an intact magic but a garbage length;
  // anything above this cap is treated as lost framing, not an allocation.
  static constexpr uint32_t kMaxPayload = 1u << 30;

  bool LoadChunk() {
    records_.clear();
    idx_ = 0;
    for (;;) {
      long chunk_start = ftell(f_);
      if (chunk_start < 0) return false;
      uint32_t header[4];
      if (fread(header, sizeof(header), 1, f_) != 1) return false;  // EOF
      if (header[0] != kMagic) {
        // lost framing: scan forward one byte at a time for the magic
        if (fseek(f_, chunk_start + 1, SEEK_SET)) return false;
        continue;
      }
      uint32_t payload_len = header[2];
      if (payload_len == 0 || payload_len > kMaxPayload) {
        if (fseek(f_, chunk_start + 1, SEEK_SET)) return false;
        continue;
      }
      std::vector<uint8_t> payload(payload_len);
      if (fread(payload.data(), 1, payload_len, f_) != payload_len) {
        // short read: either the true tail (the rescan hits EOF below) or
        // a corrupt length that ran past valid chunks — rescan, don't
        // silently drop the rest of the file
        if (fseek(f_, chunk_start + 1, SEEK_SET)) return false;
        continue;
      }
      if (Crc32(payload.data(), payload_len) != header[3]) {
        // corrupt payload: resume the magic scan past this header so any
        // intact chunk inside the damaged span is still recovered
        if (fseek(f_, chunk_start + 1, SEEK_SET)) return false;
        continue;
      }
      // parse records
      size_t off = 0;
      bool good = true;
      std::vector<std::string> recs;
      for (uint32_t i = 0; i < header[1]; ++i) {
        if (off + 4 > payload_len) {
          good = false;
          break;
        }
        uint32_t l;
        memcpy(&l, payload.data() + off, 4);
        off += 4;
        if (off + l > payload_len) {
          good = false;
          break;
        }
        recs.emplace_back(reinterpret_cast<char*>(payload.data() + off), l);
        off += l;
      }
      if (!good) continue;  // malformed chunk: skip
      records_ = std::move(recs);
      return !records_.empty();
    }
  }

  FILE* f_;
  std::vector<std::string> records_;
  size_t idx_ = 0;
};

}  // namespace recordio

// ---------------- C API (ctypes) ----------------
extern "C" {

void* recordio_writer_open(const char* path, uint32_t max_chunk_records) {
  auto* w = new recordio::Writer(path, max_chunk_records);
  if (!w->ok()) {
    delete w;
    return nullptr;
  }
  return w;
}

void recordio_writer_write(void* w, const uint8_t* data, uint32_t len) {
  static_cast<recordio::Writer*>(w)->Write(data, len);
}

// returns 1 on success, 0 if any write failed (file must be considered bad)
int recordio_writer_close(void* w) {
  auto* wr = static_cast<recordio::Writer*>(w);
  int ok = wr->Close() ? 1 : 0;
  delete wr;
  return ok;
}

void* recordio_reader_open(const char* path) {
  auto* r = new recordio::Reader(path);
  if (!r->ok()) {
    delete r;
    return nullptr;
  }
  return r;
}

// returns length, or -1 at EOF. If the buffer is too small the record is
// NOT consumed and (-2 - required_size) is returned — call again with a
// larger buffer.
int64_t recordio_reader_next(void* r, uint8_t* buf, int64_t buf_len) {
  auto* rd = static_cast<recordio::Reader*>(r);
  const std::string* rec = rd->Peek();
  if (!rec) return -1;
  if (static_cast<int64_t>(rec->size()) > buf_len)
    return -2 - static_cast<int64_t>(rec->size());
  memcpy(buf, rec->data(), rec->size());
  int64_t n = static_cast<int64_t>(rec->size());
  rd->Consume();
  return n;
}

void recordio_reader_close(void* r) {
  delete static_cast<recordio::Reader*>(r);
}
}
