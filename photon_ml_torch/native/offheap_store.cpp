// Off-heap immutable feature-index store ("photonix" format).
//
// TPU-native equivalent of the reference's PalDB-backed index maps
// (photon-api index/PalDBIndexMap.scala:26-56): feature-key -> int index
// lookups served from a memory-mapped file instead of process heap, so a
// multi-hundred-million-feature vocabulary costs no Python/JVM memory and
// is shared page-cache-resident across worker processes.
//
// File layout (all integers little-endian uint64):
//   [0]  magic "PHOTONIX"
//   [8]  version (=1)
//   [16] n               number of keys
//   [24] table_size      open-addressing slots (power of two, >= 2n)
//   [32] keys_blob_size  total bytes of concatenated keys
//   [40] offsets         (n+1) * u64   key i = blob[offsets[i], offsets[i+1])
//   [..] table           table_size * u64   slot value = index+1, 0 = empty
//   [..] keys blob
//
// Probing: FNV-1a 64 hash, linear probe, key bytes compared against the
// blob. Build is single-pass; the store is immutable after build (the
// same contract PalDB offers).
//
// C ABI only — consumed from Python via ctypes.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <vector>

namespace {

constexpr char kMagic[8] = {'P', 'H', 'O', 'T', 'O', 'N', 'I', 'X'};
constexpr uint64_t kVersion = 1;
constexpr uint64_t kHeaderBytes = 40;

uint64_t fnv1a(const char* data, uint64_t len) {
  uint64_t h = 1469598103934665603ULL;
  for (uint64_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= 1099511628211ULL;
  }
  return h;
}

uint64_t table_size_for(uint64_t n) {
  uint64_t size = 16;
  while (size < 2 * n) size <<= 1;  // load factor <= 0.5
  return size;
}

struct Store {
  int fd = -1;
  const char* base = nullptr;
  uint64_t bytes = 0;
  uint64_t n = 0;
  uint64_t table_size = 0;
  const uint64_t* offsets = nullptr;  // n + 1
  const uint64_t* table = nullptr;    // table_size
  const char* blob = nullptr;
};

}  // namespace

extern "C" {

void om_close(void* handle);

// Build the store. keys_blob: concatenated key bytes; offsets: n+1 entries.
// Index of key i is i. Returns 0 on success, negative errno-style code.
int64_t om_build(const char* path, const char* keys_blob,
                 const uint64_t* offsets, uint64_t n) {
  const uint64_t blob_size = offsets[n];
  const uint64_t table_size = table_size_for(n);

  std::vector<uint64_t> table(table_size, 0);
  const uint64_t mask = table_size - 1;
  for (uint64_t i = 0; i < n; ++i) {
    const char* key = keys_blob + offsets[i];
    const uint64_t len = offsets[i + 1] - offsets[i];
    uint64_t slot = fnv1a(key, len) & mask;
    for (;;) {
      if (table[slot] == 0) {
        table[slot] = i + 1;
        break;
      }
      // duplicate key check: identical bytes are a build error
      const uint64_t other = table[slot] - 1;
      const uint64_t olen = offsets[other + 1] - offsets[other];
      if (olen == len &&
          std::memcmp(keys_blob + offsets[other], key, len) == 0) {
        return -2;  // duplicate key
      }
      slot = (slot + 1) & mask;
    }
  }

  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  uint64_t header[5];
  std::memcpy(header, kMagic, 8);
  header[1] = kVersion;
  header[2] = n;
  header[3] = table_size;
  header[4] = blob_size;
  bool ok = std::fwrite(header, sizeof(header), 1, f) == 1;
  ok = ok && std::fwrite(offsets, sizeof(uint64_t), n + 1, f) == n + 1;
  ok = ok && std::fwrite(table.data(), sizeof(uint64_t), table_size, f) == table_size;
  ok = ok && (blob_size == 0 ||
              std::fwrite(keys_blob, 1, blob_size, f) == blob_size);
  if (std::fclose(f) != 0) ok = false;
  if (!ok) std::remove(path);  // never leave a truncated store behind
  return ok ? 0 : -1;
}

// Open a store; returns an opaque handle (heap pointer) or null.
void* om_open(const char* path) {
  int fd = ::open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<uint64_t>(st.st_size) < kHeaderBytes) {
    ::close(fd);
    return nullptr;
  }
  void* mapped = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (mapped == MAP_FAILED) {
    ::close(fd);
    return nullptr;
  }
  const char* base = static_cast<const char*>(mapped);
  const uint64_t* header = reinterpret_cast<const uint64_t*>(base);
  const uint64_t file_size = static_cast<uint64_t>(st.st_size);
  bool valid = std::memcmp(base, kMagic, 8) == 0 && header[1] == kVersion;
  if (valid) {
    const uint64_t n = header[2];
    const uint64_t table_size = header[3];
    const uint64_t blob_size = header[4];
    // reject corrupt/truncated stores: sizes must be internally consistent
    // with the mapped length, table_size a power of two able to hold n
    valid = table_size != 0 && (table_size & (table_size - 1)) == 0 &&
            n <= table_size &&
            n < (UINT64_MAX - 1) / 8 &&
            file_size >= kHeaderBytes + 8 * (n + 1) + 8 * table_size &&
            file_size - (kHeaderBytes + 8 * (n + 1) + 8 * table_size) >=
                blob_size;
  }
  if (!valid) {
    munmap(mapped, st.st_size);
    ::close(fd);
    return nullptr;
  }
  auto* s = new Store();
  s->fd = fd;
  s->base = base;
  s->bytes = st.st_size;
  s->n = header[2];
  s->table_size = header[3];
  s->offsets = reinterpret_cast<const uint64_t*>(base + kHeaderBytes);
  s->table = s->offsets + (s->n + 1);
  s->blob = reinterpret_cast<const char*>(s->table + s->table_size);
  // one pass over the offsets: monotone and bounded by the blob keeps every
  // later key comparison in-bounds
  const uint64_t blob_size = header[4];
  for (uint64_t i = 0; i < s->n; ++i) {
    if (s->offsets[i] > s->offsets[i + 1] || s->offsets[i + 1] > blob_size) {
      om_close(s);
      return nullptr;
    }
  }
  return s;
}

void om_close(void* handle) {
  if (!handle) return;
  auto* s = static_cast<Store*>(handle);
  munmap(const_cast<char*>(s->base), s->bytes);
  ::close(s->fd);
  delete s;
}

int64_t om_size(void* handle) {
  return handle ? static_cast<int64_t>(static_cast<Store*>(handle)->n) : -1;
}

// Look up a key; returns its index or -1.
int64_t om_get(void* handle, const char* key, uint64_t len) {
  const auto* s = static_cast<Store*>(handle);
  const uint64_t mask = s->table_size - 1;
  uint64_t slot = fnv1a(key, len) & mask;
  for (;;) {
    const uint64_t entry = s->table[slot];
    if (entry == 0) return -1;
    const uint64_t idx = entry - 1;
    const uint64_t klen = s->offsets[idx + 1] - s->offsets[idx];
    if (klen == len &&
        std::memcmp(s->blob + s->offsets[idx], key, len) == 0) {
      return static_cast<int64_t>(idx);
    }
    slot = (slot + 1) & mask;
  }
}

// Reverse lookup: copy key bytes of `index` into buf (if it fits);
// returns the key length, or -1 for a bad index.
int64_t om_key_at(void* handle, uint64_t index, char* buf, uint64_t buflen) {
  const auto* s = static_cast<Store*>(handle);
  if (index >= s->n) return -1;
  const uint64_t len = s->offsets[index + 1] - s->offsets[index];
  if (len <= buflen) {
    std::memcpy(buf, s->blob + s->offsets[index], len);
  }
  return static_cast<int64_t>(len);
}

}  // extern "C"
