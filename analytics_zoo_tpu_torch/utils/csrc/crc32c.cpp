// CRC32C (Castagnoli), slice-by-8, behind a plain C interface for ctypes.
//
// The same table construction and loop as the JAX package's native data
// runtime (native/zoo_data.cpp, zoo_crc32c): the checkpoint store checks
// every file it writes and reads with it, and the pure-Python table loop
// would take minutes over a BERT-base checkpoint.
//
// Build: g++ -O3 -shared -fPIC crc32c.cpp -o libzoo_torch_crc32c.so
// (utils/crc32c.py builds it at first use).

#include <cstdint>
#include <cstring>
#include <mutex>

extern "C" {

static uint32_t g_tables[8][256];
static std::once_flag g_once;

static void crc32c_init() {
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int k = 0; k < 8; ++k)
      crc = (crc >> 1) ^ ((crc & 1) ? poly : 0);
    g_tables[0][i] = crc;
  }
  for (int t = 1; t < 8; ++t)
    for (uint32_t i = 0; i < 256; ++i)
      g_tables[t][i] =
          (g_tables[t - 1][i] >> 8) ^ g_tables[0][g_tables[t - 1][i] & 0xFF];
}

uint32_t zoo_torch_crc32c(const uint8_t* data, uint64_t len, uint32_t crc) {
  std::call_once(g_once, crc32c_init);
  crc ^= 0xFFFFFFFFu;
  while (len >= 8) {
    uint64_t word;
    std::memcpy(&word, data, 8);
    crc ^= static_cast<uint32_t>(word);
    uint32_t hi = static_cast<uint32_t>(word >> 32);
    crc = g_tables[7][crc & 0xFF] ^ g_tables[6][(crc >> 8) & 0xFF] ^
          g_tables[5][(crc >> 16) & 0xFF] ^ g_tables[4][crc >> 24] ^
          g_tables[3][hi & 0xFF] ^ g_tables[2][(hi >> 8) & 0xFF] ^
          g_tables[1][(hi >> 16) & 0xFF] ^ g_tables[0][hi >> 24];
    data += 8;
    len -= 8;
  }
  while (len--) crc = g_tables[0][(crc ^ *data++) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

}  // extern "C"
