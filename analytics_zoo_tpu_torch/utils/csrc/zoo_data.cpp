// zoo_data: the host data path's native runtime for the PyTorch port.
//
// The TFRecord reader and the host arena of the JAX package's
// native/zoo_data.cpp (zoo_tfrecord_*, zoo_arena_*), copied: a
// CRC32C-validating block reader that parses a whole TFRecord file into
// one payload buffer and its record offsets, and a 64-byte-aligned bump
// arena (the PMEM/DIRECT memory tier's equivalent). The checksum loop is
// the slice-by-8 loop of crc32c.cpp, kept internal here. A plain C
// interface consumed through ctypes (utils/native_loader.py builds this
// file with g++ at first use into build/torch_native/).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <new>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// crc32c (slice-by-8)
// ---------------------------------------------------------------------------

static uint32_t g_crc_tables[8][256];
static std::once_flag g_crc_once;

static void crc32c_init() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int k = 0; k < 8; ++k)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    g_crc_tables[0][i] = crc;
  }
  for (int t = 1; t < 8; ++t)
    for (uint32_t i = 0; i < 256; ++i)
      g_crc_tables[t][i] =
          (g_crc_tables[t - 1][i] >> 8) ^
          g_crc_tables[0][g_crc_tables[t - 1][i] & 0xFF];
}

static uint32_t crc32c(const uint8_t* data, uint64_t len, uint32_t crc) {
  std::call_once(g_crc_once, crc32c_init);
  crc ^= 0xFFFFFFFFu;
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    crc ^= static_cast<uint32_t>(word);
    uint32_t hi = static_cast<uint32_t>(word >> 32);
    crc = g_crc_tables[7][crc & 0xFF] ^ g_crc_tables[6][(crc >> 8) & 0xFF] ^
          g_crc_tables[5][(crc >> 16) & 0xFF] ^ g_crc_tables[4][crc >> 24] ^
          g_crc_tables[3][hi & 0xFF] ^ g_crc_tables[2][(hi >> 8) & 0xFF] ^
          g_crc_tables[1][(hi >> 16) & 0xFF] ^ g_crc_tables[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) crc = g_crc_tables[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

static inline uint32_t masked_crc(const uint8_t* data, uint64_t len) {
  uint32_t crc = crc32c(data, len, 0);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// TFRecord reader: parse a whole file into (payload buffer, offsets)
// ---------------------------------------------------------------------------

struct ZooRecordFile {
  std::vector<uint8_t> payload;   // concatenated record bodies
  std::vector<uint64_t> offsets;  // record i = payload[offsets[i]..offsets[i+1])
  char error[256];
};

// Returns handle (or null). error_out (optional, >=256 bytes) gets a message.
ZooRecordFile* zoo_tfrecord_open(const char* path, int verify_crc,
                                 char* error_out) {
  auto fail = [&](const char* msg) -> ZooRecordFile* {
    if (error_out) std::snprintf(error_out, 256, "%s: %s", msg, path);
    return nullptr;
  };
  FILE* f = std::fopen(path, "rb");
  if (!f) return fail("cannot open");
  auto* rec = new (std::nothrow) ZooRecordFile();
  if (!rec) {
    std::fclose(f);
    return fail("out of memory");
  }
  rec->offsets.push_back(0);
  uint8_t header[12];
  for (;;) {
    size_t got = std::fread(header, 1, 12, f);
    if (got == 0) break;  // clean EOF
    if (got < 12) {
      std::fclose(f);
      delete rec;
      return fail("truncated header");
    }
    uint64_t len;
    uint32_t len_crc;
    std::memcpy(&len, header, 8);
    std::memcpy(&len_crc, header + 8, 4);
    // ALWAYS validate the length crc before trusting len — a garbage
    // 8-byte length would otherwise drive a multi-GB resize (and the
    // exception would escape the C ABI and abort the process).
    if (masked_crc(header, 8) != len_crc) {
      std::fclose(f);
      delete rec;
      return fail("length crc mismatch (not a TFRecord?)");
    }
    size_t base = rec->payload.size();
    try {
      rec->payload.resize(base + len);
    } catch (const std::exception&) {
      std::fclose(f);
      delete rec;
      return fail("record too large");
    }
    if (std::fread(rec->payload.data() + base, 1, len, f) != len) {
      std::fclose(f);
      delete rec;
      return fail("truncated record");
    }
    uint32_t data_crc;
    if (std::fread(&data_crc, 1, 4, f) != 4) {
      std::fclose(f);
      delete rec;
      return fail("truncated data crc");
    }
    if (verify_crc &&
        masked_crc(rec->payload.data() + base, len) != data_crc) {
      std::fclose(f);
      delete rec;
      return fail("data crc mismatch");
    }
    rec->offsets.push_back(rec->payload.size());
  }
  std::fclose(f);
  return rec;
}

uint64_t zoo_tfrecord_count(ZooRecordFile* rec) {
  return rec->offsets.size() - 1;
}

const uint8_t* zoo_tfrecord_payload(ZooRecordFile* rec) {
  return rec->payload.data();
}

const uint64_t* zoo_tfrecord_offsets(ZooRecordFile* rec) {
  return rec->offsets.data();
}

void zoo_tfrecord_close(ZooRecordFile* rec) { delete rec; }

// ---------------------------------------------------------------------------
// Host arena allocator — the PMEM/DIRECT memory-tier equivalent.
// Bump allocation of 64-byte-aligned blocks out of one mmap-sized slab;
// samples are staged here once and read as numpy views without
// re-serialization (the reference staged them in Optane via memkind).
// ---------------------------------------------------------------------------

struct ZooArena {
  uint8_t* base;
  uint64_t capacity;
  std::atomic<uint64_t> used;
};

ZooArena* zoo_arena_create(uint64_t capacity) {
  auto* a = new (std::nothrow) ZooArena();
  if (!a) return nullptr;
  // 64-byte alignment: friendly to vector loads on the host feeding DMA
  a->base = static_cast<uint8_t*>(std::aligned_alloc(64, capacity));
  if (!a->base) {
    delete a;
    return nullptr;
  }
  a->capacity = capacity;
  a->used.store(0);
  return a;
}

// Thread-safe bump alloc; returns offset or UINT64_MAX when full.
uint64_t zoo_arena_alloc(ZooArena* a, uint64_t nbytes) {
  uint64_t aligned = (nbytes + 63u) & ~uint64_t(63);
  uint64_t off = a->used.fetch_add(aligned);
  if (off + aligned > a->capacity) {
    a->used.fetch_sub(aligned);
    return UINT64_MAX;
  }
  return off;
}

uint8_t* zoo_arena_base(ZooArena* a) { return a->base; }
uint64_t zoo_arena_capacity(ZooArena* a) { return a->capacity; }
uint64_t zoo_arena_used(ZooArena* a) { return a->used.load(); }
void zoo_arena_reset(ZooArena* a) { a->used.store(0); }

void zoo_arena_destroy(ZooArena* a) {
  if (a) {
    std::free(a->base);
    delete a;
  }
}

}  // extern "C"
