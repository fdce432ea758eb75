// Append-only CRC32-framed journal — native backend of the port's WAL.
//
// The performance-critical half of the WAL (the analog of the Journaler
// append path of gigapaxos, SQLPaxosLogger.java:965-1076, which it keeps
// fast by batching and fsyncing off the critical thread).  Format matches
// gigapaxos_tpu_torch/wal/journal.py (and the JAX package's journal) byte
// for byte:
//   file      := MAGIC record*
//   v1 record := u32 len | u32 crc32(payload) | payload       ("GPTPUJ01")
//   v2 record := u32 len | u32 crc32(body)    | body          ("GPTPUJ02")
//   body      := u8 kind | u64 seq | payload   (little-endian throughout)
//   kind      := 0 DATA | 1 BARRIER (empty payload, appended before fsync)
// A torn tail is truncated on open so appends after a crash stay readable.
// Scribble *classification* (mid-log corruption with intact frames after
// it) is the Python scanner's job — wal/native_journal.py pre-scans with
// wal.journal.scan_journal before calling gpj_open, so this
// open never truncates fsynced data.  A file whose magic matches neither
// version is refused (returns nullptr) rather than clobbered: a flipped
// magic byte is a scribble, not an invitation to rewrite the file.
//
// Exposed as a C ABI for ctypes.  Appends are buffered in user space;
// gpj_sync() writes a BARRIER frame (v2, if dirty) then flushes +
// fdatasyncs (group commit).
//
// CRC-32 is computed here (zlib's reflected polynomial 0xEDB88320, init and
// final xor 0xFFFFFFFF, slicing by 8 bytes) rather than taken from zlib, so
// the library builds with no header or library beyond the C++ runtime.
// gpj_crc32 exposes it so the tests can hold it against zlib.crc32.

#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <unistd.h>

namespace {

constexpr char kMagic1[8] = {'G', 'P', 'T', 'P', 'U', 'J', '0', '1'};
constexpr char kMagic2[8] = {'G', 'P', 'T', 'P', 'U', 'J', '0', '2'};
constexpr size_t kBufCap = 1 << 20;  // 1 MiB append buffer
constexpr size_t kBodyPfx = 9;       // u8 kind + u64 seq

// CRC-32 tables for slicing by 8: kCrc[0] is the classic byte table,
// kCrc[k][b] the CRC of byte b followed by k zero bytes.
struct CrcTables {
  uint32_t t[8][256];
  CrcTables() {
    for (uint32_t b = 0; b < 256; ++b) {
      uint32_t c = b;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ (0xEDB88320u & (0u - (c & 1u)));
      t[0][b] = c;
    }
    for (uint32_t b = 0; b < 256; ++b)
      for (int k = 1; k < 8; ++k)
        t[k][b] = (t[k - 1][b] >> 8) ^ t[0][t[k - 1][b] & 0xFFu];
  }
};

const CrcTables kCrc;

// Running CRC-32 of p[0, n) continuing from crc (0 for a fresh sum), the
// same value as zlib's crc32(crc, p, n).
uint32_t crc32(uint32_t crc, const uint8_t* p, size_t n) {
  uint32_t c = ~crc;
  while (n >= 8) {
    uint32_t lo, hi;
    memcpy(&lo, p, 4);  // little-endian host
    memcpy(&hi, p + 4, 4);
    lo ^= c;
    c = kCrc.t[7][lo & 0xFFu] ^ kCrc.t[6][(lo >> 8) & 0xFFu] ^
        kCrc.t[5][(lo >> 16) & 0xFFu] ^ kCrc.t[4][lo >> 24] ^
        kCrc.t[3][hi & 0xFFu] ^ kCrc.t[2][(hi >> 8) & 0xFFu] ^
        kCrc.t[1][(hi >> 16) & 0xFFu] ^ kCrc.t[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) c = (c >> 8) ^ kCrc.t[0][(c ^ *p++) & 0xFFu];
  return ~c;
}

struct Journal {
  int fd = -1;
  uint8_t* buf = nullptr;
  size_t buf_len = 0;
  int version = 2;
  uint64_t seq = 0;   // last frame seq written (v2)
  bool dirty = false; // data appended since the last barrier
};

bool write_all(int fd, const uint8_t* p, size_t n) {
  while (n > 0) {
    ssize_t w = ::write(fd, p, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    p += w;
    n -= static_cast<size_t>(w);
  }
  return true;
}

bool flush_buf(Journal* j) {
  if (j->buf_len == 0) return true;
  if (!write_all(j->fd, j->buf, j->buf_len)) return false;
  j->buf_len = 0;
  return true;
}

// Scan an existing journal; return the byte length of the intact prefix
// and (v2) the seq of its last frame.  Mirrors wal/journal.py
// _parse_frames: v2 frames must carry strictly increasing seq — both
// backends must truncate at the same offset for the same bytes.
off_t valid_length(int fd, int version, uint64_t* last_seq) {
  off_t pos = sizeof(kMagic2);
  off_t end = ::lseek(fd, 0, SEEK_END);
  uint8_t hdr[8];
  uint8_t* payload = static_cast<uint8_t*>(malloc(kBufCap));
  size_t payload_cap = kBufCap;
  uint64_t seq = 0;
  while (pos + 8 <= end) {
    if (::pread(fd, hdr, 8, pos) != 8) break;
    uint32_t len, crc;
    memcpy(&len, hdr, 4);
    memcpy(&crc, hdr + 4, 4);
    if (pos + 8 + (off_t)len > end) break;
    if (len > payload_cap) {
      uint8_t* grown = static_cast<uint8_t*>(realloc(payload, len));
      if (grown == nullptr) break;  // treat as tear; recovery must not crash
      payload = grown;
      payload_cap = len;
    }
    if (::pread(fd, payload, len, pos + 8) != (ssize_t)len) break;
    if (crc32(0, payload, len) != crc) break;
    if (version == 2) {
      if (len < kBodyPfx) break;
      uint8_t kind = payload[0];
      uint64_t s;
      memcpy(&s, payload + 1, 8);
      if (s != seq + 1 || kind > 1) break;
      seq = s;
    }
    pos += 8 + (off_t)len;
  }
  free(payload);
  *last_seq = seq;
  return pos;
}

// Frame a v2 record into dst (caller sized it): returns frame length.
size_t frame_v2(Journal* j, uint8_t kind, const uint8_t* data, uint32_t len,
                uint8_t* dst) {
  uint32_t body_len = kBodyPfx + len;
  uint64_t seq = ++j->seq;
  dst[8] = kind;
  memcpy(dst + 9, &seq, 8);
  if (len > 0) memcpy(dst + 8 + kBodyPfx, data, len);
  uint32_t crc = crc32(0, dst + 8, body_len);
  memcpy(dst, &body_len, 4);
  memcpy(dst + 4, &crc, 4);
  return 8 + body_len;
}

// Append a barrier frame (v2): rides the fsync it marks, so after a crash
// the last intact barrier bounds the acked region (see wal/journal.py).
bool append_barrier(Journal* j) {
  uint8_t frame[8 + kBodyPfx];
  size_t n = frame_v2(j, 1, nullptr, 0, frame);
  if (n > kBufCap - j->buf_len) {
    if (!flush_buf(j)) return false;
  }
  memcpy(j->buf + j->buf_len, frame, n);
  j->buf_len += n;
  j->dirty = false;
  return true;
}

}  // namespace

extern "C" {

uint32_t gpj_crc32(const uint8_t* data, uint32_t len, uint32_t crc) {
  return crc32(crc, data, len);
}

void* gpj_open(const char* path) {
  int fd = ::open(path, O_RDWR | O_CREAT, 0644);
  if (fd < 0) return nullptr;
  off_t size = ::lseek(fd, 0, SEEK_END);
  int version = 2;
  uint64_t last_seq = 0;
  if (size > 0 && size < (off_t)sizeof(kMagic2)) {
    // tear during file creation: nothing after an unwritten magic was
    // ever fsync-acked — start over
    if (::ftruncate(fd, 0) != 0) { ::close(fd); return nullptr; }
    size = 0;
  }
  if (size > 0) {
    char magic[sizeof(kMagic2)];
    if (::pread(fd, magic, sizeof(magic), 0) != (ssize_t)sizeof(magic)) {
      ::close(fd);
      return nullptr;
    }
    if (memcmp(magic, kMagic2, sizeof(kMagic2)) == 0) {
      version = 2;
    } else if (memcmp(magic, kMagic1, sizeof(kMagic1)) == 0) {
      version = 1;  // continue legacy files in v1 format (no mixing)
    } else {
      ::close(fd);  // damaged magic = scribble: refuse, never clobber
      return nullptr;
    }
    off_t good = valid_length(fd, version, &last_seq);
    if (good < size) {
      if (::ftruncate(fd, good) != 0) { ::close(fd); return nullptr; }
    }
    ::lseek(fd, 0, SEEK_END);
  }
  if (size == 0) {
    if (!write_all(fd, reinterpret_cast<const uint8_t*>(kMagic2),
                   sizeof(kMagic2))) {
      ::close(fd);
      return nullptr;
    }
  }
  Journal* j = new Journal();
  j->fd = fd;
  j->buf = static_cast<uint8_t*>(malloc(kBufCap));
  j->version = version;
  j->seq = last_seq;
  return j;
}

int gpj_append(void* h, const uint8_t* data, uint32_t len) {
  Journal* j = static_cast<Journal*>(h);
  if (j->version == 1) {
    uint32_t crc = crc32(0, data, len);
    uint8_t hdr[8];
    memcpy(hdr, &len, 4);
    memcpy(hdr + 4, &crc, 4);
    if (8 + (size_t)len > kBufCap - j->buf_len) {
      if (!flush_buf(j)) return -1;
    }
    if (8 + (size_t)len > kBufCap) {  // oversized record: write through
      if (!write_all(j->fd, hdr, 8) || !write_all(j->fd, data, len))
        return -1;
      j->dirty = true;
      return 0;
    }
    memcpy(j->buf + j->buf_len, hdr, 8);
    memcpy(j->buf + j->buf_len + 8, data, len);
    j->buf_len += 8 + len;
    j->dirty = true;
    return 0;
  }
  size_t frame_len = 8 + kBodyPfx + (size_t)len;
  if (frame_len > kBufCap - j->buf_len) {
    if (!flush_buf(j)) return -1;
  }
  if (frame_len > kBufCap) {  // oversized record: frame on heap, write through
    uint8_t* frame = static_cast<uint8_t*>(malloc(frame_len));
    if (frame == nullptr) return -1;
    frame_v2(j, 0, data, len, frame);
    bool ok = write_all(j->fd, frame, frame_len);
    free(frame);
    if (!ok) return -1;
    j->dirty = true;
    return 0;
  }
  frame_v2(j, 0, data, len, j->buf + j->buf_len);
  j->buf_len += frame_len;
  j->dirty = true;
  return 0;
}

int gpj_sync(void* h) {
  Journal* j = static_cast<Journal*>(h);
  if (j->version == 2 && j->dirty) {
    if (!append_barrier(j)) return -1;
  }
  j->dirty = false;
  if (!flush_buf(j)) return -1;
  return ::fdatasync(j->fd);
}

void gpj_close(void* h) {
  Journal* j = static_cast<Journal*>(h);
  if (j == nullptr) return;
  if (j->version == 2 && j->dirty) append_barrier(j);
  flush_buf(j);
  ::fdatasync(j->fd);
  ::close(j->fd);
  free(j->buf);
  delete j;
}

}  // extern "C"
