// Native spectra loader: multithreaded npz (zip-of-npy) batch reader.
//
// The PyTorch port's copy of qfa_tpu/native/npz_reader.cpp. It replaces
// the reference's host-side multiprocessing pool (QFA/dataloader.py:33-44
// of the upstream project) with a C++ thread pool that parses each npz
// (ZIP) container directly, converts the flux/error arrays to float32,
// applies the -999 missing-pixel sentinel convention
// (QFA/dataloader.py:24-28), and writes straight into the caller's
// preallocated (N, npix) buffers — no Python objects, no pickling, no
// per-file ndarray allocation.
//
// Supports STORED and DEFLATE zip entries (zlib), '<f4' and '<f8' npy
// payloads, and numpy 1.0/2.0 npy headers.
//
// Exposed C ABI (see qfa_tpu_torch/native/__init__.py for the ctypes
// binding):
//   int qfa_read_spectra(const char** paths, int n_files, int npix,
//                        float* flux, float* error, unsigned char* mask,
//                        unsigned char* flux_ok, float* z, int n_threads,
//                        char* errbuf, int errbuf_len);
//
// flux_ok is the raw `flux != -999` indicator (before the combined
// flux/error mask), needed for exact reference mu-denominator semantics
// (QFA/dataloader.py:111).
// Returns 0 on success; nonzero = number of failed files (first error
// message in errbuf).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#if __has_include(<zlib.h>) && !defined(QFA_DECLARE_ZLIB)
#include <zlib.h>
#else
// No zlib headers on this machine (or QFA_DECLARE_ZLIB set): declare the
// few entry points the reader calls, with zlib 1.x's ABI, and link the
// libz.so.1 the Python interpreter itself loads. inflateInit2_ checks the
// version's first character and the struct's size.
extern "C" {
typedef struct z_stream_s {
  const unsigned char* next_in;
  unsigned int avail_in;
  unsigned long total_in;
  unsigned char* next_out;
  unsigned int avail_out;
  unsigned long total_out;
  const char* msg;
  struct internal_state* state;
  void* (*zalloc)(void*, unsigned int, unsigned int);
  void (*zfree)(void*, void*);
  void* opaque;
  int data_type;
  unsigned long adler;
  unsigned long reserved;
} z_stream;
int inflateInit2_(z_stream* strm, int window_bits, const char* version,
                  int stream_size);
int inflate(z_stream* strm, int flush);
int inflateEnd(z_stream* strm);
}
#define Z_OK 0
#define Z_STREAM_END 1
#define Z_FINISH 4
#define MAX_WBITS 15
#define inflateInit2(strm, window_bits) \
  inflateInit2_((strm), (window_bits), "1", (int)sizeof(z_stream))
#endif

namespace {

constexpr float kMissing = -999.0f;

struct ZipEntry {
  std::string name;
  uint16_t method = 0;       // 0 = stored, 8 = deflate
  uint32_t comp_size = 0;
  uint32_t uncomp_size = 0;
  uint32_t local_offset = 0;
};

struct Blob {
  std::vector<uint8_t> data;
};

bool read_file(const char* path, std::vector<uint8_t>& out, std::string& err) {
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    err = std::string("cannot open ") + path;
    return false;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  if (size <= 0) {
    std::fclose(f);
    err = std::string("empty file ") + path;
    return false;
  }
  out.resize(static_cast<size_t>(size));
  size_t got = std::fread(out.data(), 1, out.size(), f);
  std::fclose(f);
  if (got != out.size()) {
    err = std::string("short read ") + path;
    return false;
  }
  return true;
}

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// Parse the central directory of an in-memory zip.
bool parse_zip(const std::vector<uint8_t>& buf, std::vector<ZipEntry>& entries,
               std::string& err) {
  // find end-of-central-directory record (signature 0x06054b50)
  if (buf.size() < 22) {
    err = "not a zip (too small)";
    return false;
  }
  size_t eocd = std::string::npos;
  size_t scan_start = buf.size() >= 22 + 65536 ? buf.size() - 22 - 65536 : 0;
  for (size_t i = buf.size() - 22 + 1; i-- > scan_start;) {
    if (rd32(&buf[i]) == 0x06054b50) {
      eocd = i;
      break;
    }
  }
  if (eocd == std::string::npos) {
    err = "zip EOCD not found";
    return false;
  }
  uint16_t n_entries = rd16(&buf[eocd + 10]);
  uint32_t cd_offset = rd32(&buf[eocd + 16]);
  size_t p = cd_offset;
  for (int i = 0; i < n_entries; ++i) {
    if (p + 46 > buf.size() || rd32(&buf[p]) != 0x02014b50) {
      err = "bad central directory";
      return false;
    }
    ZipEntry e;
    e.method = rd16(&buf[p + 10]);
    e.comp_size = rd32(&buf[p + 20]);
    e.uncomp_size = rd32(&buf[p + 24]);
    uint16_t name_len = rd16(&buf[p + 28]);
    uint16_t extra_len = rd16(&buf[p + 30]);
    uint16_t comment_len = rd16(&buf[p + 32]);
    e.local_offset = rd32(&buf[p + 42]);
    // validate the full record extent before touching the name bytes: a
    // truncated/corrupt npz with large name/extra/comment lengths must not
    // read out of bounds.
    if (p + 46 + size_t(name_len) + extra_len + comment_len > buf.size()) {
      err = "truncated central directory record";
      return false;
    }
    e.name.assign(reinterpret_cast<const char*>(&buf[p + 46]), name_len);
    entries.push_back(std::move(e));
    p += 46 + name_len + extra_len + comment_len;
  }
  return true;
}

// Extract one entry's payload (decompressing if needed).
bool extract(const std::vector<uint8_t>& buf, const ZipEntry& e,
             std::vector<uint8_t>& out, std::string& err) {
  size_t p = e.local_offset;
  if (p + 30 > buf.size() || rd32(&buf[p]) != 0x04034b50) {
    err = "bad local header";
    return false;
  }
  uint16_t name_len = rd16(&buf[p + 26]);
  uint16_t extra_len = rd16(&buf[p + 28]);
  size_t data_off = p + 30 + name_len + extra_len;
  if (data_off + e.comp_size > buf.size()) {
    err = "truncated entry";
    return false;
  }
  if (e.method == 0) {
    out.assign(buf.begin() + data_off, buf.begin() + data_off + e.comp_size);
    return true;
  }
  if (e.method == 8) {
    out.resize(e.uncomp_size);
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -MAX_WBITS) != Z_OK) {
      err = "inflateInit failed";
      return false;
    }
    zs.next_in = const_cast<uint8_t*>(&buf[data_off]);
    zs.avail_in = e.comp_size;
    zs.next_out = out.data();
    zs.avail_out = e.uncomp_size;
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END) {
      err = "inflate failed";
      return false;
    }
    return true;
  }
  err = "unsupported zip method";
  return false;
}

// Parse an npy payload: returns element dtype ('f' only), itemsize,
// element count, and pointer to raw data.
bool parse_npy(const std::vector<uint8_t>& npy, int& itemsize, size_t& count,
               const uint8_t*& data, std::string& err) {
  if (npy.size() < 10 || std::memcmp(npy.data(), "\x93NUMPY", 6) != 0) {
    err = "bad npy magic";
    return false;
  }
  uint8_t major = npy[6];
  size_t header_len, header_off;
  if (major == 1) {
    header_len = rd16(&npy[8]);
    header_off = 10;
  } else {
    // v2+ headers carry a 4-byte length at [8..12): a truncated 10-11
    // byte payload must not reach rd32 (2-byte over-read)
    if (npy.size() < 12) {
      err = "truncated npy v2 header";
      return false;
    }
    header_len = rd32(&npy[8]);
    header_off = 12;
  }
  if (header_off + header_len > npy.size()) {
    err = "bad npy header";
    return false;
  }
  std::string header(reinterpret_cast<const char*>(&npy[header_off]),
                     header_len);
  // descr
  size_t dpos = header.find("'descr'");
  if (dpos == std::string::npos) {
    err = "npy header missing descr";
    return false;
  }
  size_t q1 = header.find('\'', dpos + 7);
  size_t q2 = header.find('\'', q1 + 1);
  std::string descr = header.substr(q1 + 1, q2 - q1 - 1);
  if (descr == "<f8" || descr == "|f8") {
    itemsize = 8;
  } else if (descr == "<f4" || descr == "|f4") {
    itemsize = 4;
  } else {
    err = "unsupported npy dtype " + descr;
    return false;
  }
  if (header.find("'fortran_order': True") != std::string::npos) {
    err = "fortran order unsupported";
    return false;
  }
  data = npy.data() + header_off + header_len;
  count = (npy.size() - header_off - header_len) / itemsize;
  return true;
}

double npy_get(const uint8_t* data, int itemsize, size_t i) {
  if (itemsize == 8) {
    double v;
    std::memcpy(&v, data + 8 * i, 8);
    return v;
  }
  float v;
  std::memcpy(&v, data + 4 * i, 4);
  return v;
}

struct Shared {
  const char** paths;
  int n_files;
  int npix;
  float* flux;
  float* error;
  uint8_t* mask;
  uint8_t* flux_ok;
  float* z;
  std::atomic<int> next{0};
  std::atomic<int> failures{0};
  std::mutex err_mu;
  std::string first_err;
};

void record_err(Shared& sh, const std::string& msg) {
  sh.failures.fetch_add(1);
  std::lock_guard<std::mutex> lock(sh.err_mu);
  if (sh.first_err.empty()) sh.first_err = msg;
}

bool load_entry(const std::vector<uint8_t>& file,
                const std::vector<ZipEntry>& entries, const char* want,
                std::vector<uint8_t>& out, int& itemsize, size_t& count,
                const uint8_t*& data, std::string& err) {
  for (const auto& e : entries) {
    if (e.name == want) {
      if (!extract(file, e, out, err)) return false;
      return parse_npy(out, itemsize, count, data, err);
    }
  }
  err = std::string("entry not found: ") + want;
  return false;
}

void worker(Shared& sh) {
  std::vector<uint8_t> file, flux_blob, err_blob, z_blob;
  while (true) {
    int i = sh.next.fetch_add(1);
    if (i >= sh.n_files) return;
    std::string err;
    const char* path = sh.paths[i];
    float* flux_row = sh.flux + static_cast<size_t>(i) * sh.npix;
    float* err_row = sh.error + static_cast<size_t>(i) * sh.npix;
    uint8_t* mask_row = sh.mask + static_cast<size_t>(i) * sh.npix;
    uint8_t* fok_row = sh.flux_ok + static_cast<size_t>(i) * sh.npix;
    // default: fully masked row on failure
    std::memset(flux_row, 0, sizeof(float) * sh.npix);
    std::memset(err_row, 0, sizeof(float) * sh.npix);
    std::memset(mask_row, 0, sh.npix);
    std::memset(fok_row, 0, sh.npix);
    sh.z[i] = 0.0f;

    if (!read_file(path, file, err)) {
      record_err(sh, err);
      continue;
    }
    std::vector<ZipEntry> entries;
    if (!parse_zip(file, entries, err)) {
      record_err(sh, std::string(path) + ": " + err);
      continue;
    }
    int isf, ise, isz;
    size_t cf, ce, cz;
    const uint8_t *df, *de, *dz;
    if (!load_entry(file, entries, "flux.npy", flux_blob, isf, cf, df, err) ||
        !load_entry(file, entries, "error.npy", err_blob, ise, ce, de, err) ||
        !load_entry(file, entries, "z.npy", z_blob, isz, cz, dz, err)) {
      record_err(sh, std::string(path) + ": " + err);
      continue;
    }
    // strict grid check: longer arrays are just as wrong as shorter ones
    // (silently truncating a 2000-px spectrum onto a 1913-px grid would
    // train on misaligned flux; the Python engine fails loudly on ragged
    // rows and this engine must match that contract)
    if (cf != static_cast<size_t>(sh.npix)
        || ce != static_cast<size_t>(sh.npix) || cz < 1) {
      record_err(sh, std::string(path) + ": flux/error length " +
                         std::to_string(cf) + "/" + std::to_string(ce) +
                         " does not match the common grid npix=" +
                         std::to_string(sh.npix));
      continue;
    }
    for (int p = 0; p < sh.npix; ++p) {
      float fv = static_cast<float>(npy_get(df, isf, p));
      float ev = static_cast<float>(npy_get(de, ise, p));
      bool ok = fv != kMissing && ev != kMissing;
      mask_row[p] = ok ? 1 : 0;
      fok_row[p] = fv != kMissing ? 1 : 0;
      flux_row[p] = ok ? fv : 0.0f;
      err_row[p] = ok ? ev : 0.0f;
    }
    sh.z[i] = static_cast<float>(npy_get(dz, isz, 0));
  }
}

}  // namespace

extern "C" int qfa_read_spectra(const char** paths, int n_files, int npix,
                                float* flux, float* error, uint8_t* mask,
                                uint8_t* flux_ok, float* z, int n_threads,
                                char* errbuf, int errbuf_len) {
  Shared sh;
  sh.paths = paths;
  sh.n_files = n_files;
  sh.npix = npix;
  sh.flux = flux;
  sh.error = error;
  sh.mask = mask;
  sh.flux_ok = flux_ok;
  sh.z = z;
  int nt = n_threads > 0 ? n_threads : 1;
  if (nt > n_files) nt = n_files > 0 ? n_files : 1;
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker, std::ref(sh));
  for (auto& th : pool) th.join();
  if (sh.failures.load() > 0 && errbuf && errbuf_len > 0) {
    std::snprintf(errbuf, errbuf_len, "%s", sh.first_err.c_str());
  }
  return sh.failures.load();
}
