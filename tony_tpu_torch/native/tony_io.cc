// Native data-plane functions of tony_tpu_torch's sharded reader: host
// code, built with the host C++ compiler (not nvcc) and loaded with ctypes
// by tony_tpu_torch/io/native.py, which builds it from this file at first
// use (-O3 -fPIC -std=c++17 -shared) into the package's build directory.
//
// The port's copy of the JAX package's data-plane library, with the same
// four C symbols: record-boundary scanning for jsonl splits, record counting,
// fixed-size token-record span reads (pread) and a page-cache readahead hint
// (posix_fadvise WILLNEED). There is no fallback: a failed build raises.

#include <cstdint>
#include <fcntl.h>
#include <unistd.h>
#include <cstdio>
#include <cstring>

extern "C" {

// Scan [buf, buf+len) and record the byte offset AFTER each '\n' that is
// followed by at least one more byte (i.e. the start offset of every
// record except the first). Returns the number of offsets written; writes
// at most max_out offsets. The caller passes the file chunk and gets back
// newline-delimited record boundaries — the split-brain ownership rule
// (owner of a record's first byte reads it to completion) is applied by
// the Python layer on top of these offsets.
int64_t tony_scan_record_starts(const uint8_t* buf, int64_t len,
                                int64_t* out, int64_t max_out) {
  int64_t n = 0;
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  while (p < end && n < max_out) {
    const uint8_t* nl =
        static_cast<const uint8_t*>(memchr(p, '\n', end - p));
    if (nl == nullptr) break;
    int64_t start = (nl - buf) + 1;
    if (start < len) {
      out[n++] = start;
    }
    p = nl + 1;
  }
  return n;
}

// Decode `num_records` fixed-size records of `record_bytes` each from the
// open file descriptor `fd` starting at byte `offset` into `out`
// (caller-allocated, num_records*record_bytes). Returns the number of
// complete records read, or -1 on IO error. pread: no seek state, safe
// from any thread, and the caller keeps the fd open across chunks — one
// open per segment instead of one per chunk.
int64_t tony_pread_records(int fd, int64_t offset, int64_t record_bytes,
                           int64_t num_records, uint8_t* out) {
  size_t want = static_cast<size_t>(record_bytes) * num_records;
  size_t done = 0;
  while (done < want) {
    ssize_t got = pread(fd, out + done, want - done,
                        static_cast<off_t>(offset + done));
    if (got < 0) return -1;
    if (got == 0) break;  // EOF
    done += static_cast<size_t>(got);
  }
  return static_cast<int64_t>(done / record_bytes);
}

// Hint the kernel to start readahead for [offset, offset+len) of `fd`
// (posix_fadvise WILLNEED). The reader calls this for the NEXT span
// while the current one decodes, so cold-cache preads land warm. Returns
// 0 on success, -1 when the advice could not be applied (harmless — it
// is only a hint and the pread path never depends on it).
int64_t tony_readahead(int fd, int64_t offset, int64_t len) {
#ifdef POSIX_FADV_WILLNEED
  return posix_fadvise(fd, static_cast<off_t>(offset),
                       static_cast<off_t>(len), POSIX_FADV_WILLNEED) == 0
             ? 0 : -1;
#else
  (void)fd; (void)offset; (void)len;
  return -1;
#endif
}

// Count complete newline-terminated records in [buf, buf+len) — used for
// sizing. A trailing unterminated fragment is not counted.
int64_t tony_count_records(const uint8_t* buf, int64_t len) {
  int64_t n = 0;
  const uint8_t* p = buf;
  const uint8_t* end = buf + len;
  while (p < end) {
    const uint8_t* nl =
        static_cast<const uint8_t*>(memchr(p, '\n', end - p));
    if (nl == nullptr) break;
    ++n;
    p = nl + 1;
  }
  return n;
}

}  // extern "C"
