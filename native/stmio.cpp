// libstmio — native I/O runtime for stereomatch_tpu.
//
// Counterpart of the reference's native layer for data movement:
// where the reference links OpenCV for image/video decode (stereomatch/
// data.py, capture.py) and hand-rolls CUDA staging (cuda_texture.cpp:88-100),
// this library owns the host-side data path: Netpbm/PFM codecs for
// Middlebury assets and a YUV4MPEG2 (Y4M) stream reader with a threaded
// ring-buffer prefetcher so video decode overlaps device compute.
//
// Plain C ABI; bound from Python with ctypes (no pybind11 in this image).
//
// All functions return 0 on success and a negative errno-style code on
// failure; the last error message is retrievable per-thread.

#include <atomic>
#include <cctype>
#include <memory>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#define STMIO_API extern "C" __attribute__((visibility("default")))

namespace {

thread_local std::string g_error;

int fail(const std::string& msg, int code = -1) {
  g_error = msg;
  return code;
}

struct File {
  FILE* f = nullptr;
  explicit File(const char* path, const char* mode) : f(fopen(path, mode)) {}
  ~File() { if (f) fclose(f); }
  operator FILE*() const { return f; }
};

// Skip whitespace and '#' comment lines in a Netpbm/PFM header.
bool next_token(FILE* f, std::string* tok) {
  tok->clear();
  int c;
  while ((c = fgetc(f)) != EOF) {
    if (c == '#') {
      while ((c = fgetc(f)) != EOF && c != '\n') {}
      continue;
    }
    if (!std::isspace(c)) break;
  }
  if (c == EOF) return false;
  do {
    tok->push_back(static_cast<char>(c));
  } while ((c = fgetc(f)) != EOF && !std::isspace(c));
  return true;
}

bool next_int(FILE* f, long* value) {
  std::string tok;
  if (!next_token(f, &tok)) return false;
  char* end = nullptr;
  *value = strtol(tok.c_str(), &end, 10);
  return end && *end == '\0';
}

}  // namespace

STMIO_API const char* stmio_last_error() { return g_error.c_str(); }

// ---------------------------------------------------------------------------
// PFM (Middlebury float disparity maps; data.py:23-47 of this package)
// ---------------------------------------------------------------------------

// Probe: fills *width, *height, *channels. Data is float32, top-down rows
// (the file's bottom-up order is undone on read).
STMIO_API int stmio_pfm_probe(const char* path, int32_t* width,
                              int32_t* height, int32_t* channels) {
  File f(path, "rb");
  if (!f) return fail(std::string("cannot open ") + path);
  std::string magic;
  if (!next_token(f, &magic)) return fail("truncated PFM header");
  int ch;
  if (magic == "PF") ch = 3;
  else if (magic == "Pf") ch = 1;
  else return fail("not a PFM file: magic '" + magic + "'");
  long w, h;
  std::string scale_tok;
  if (!next_int(f, &w) || !next_int(f, &h) || !next_token(f, &scale_tok))
    return fail("truncated PFM header");
  *width = static_cast<int32_t>(w);
  *height = static_cast<int32_t>(h);
  *channels = ch;
  return 0;
}

STMIO_API int stmio_pfm_read(const char* path, float* out, int64_t out_size) {
  File f(path, "rb");
  if (!f) return fail(std::string("cannot open ") + path);
  std::string magic;
  if (!next_token(f, &magic)) return fail("truncated PFM header");
  int ch;
  if (magic == "PF") ch = 3;
  else if (magic == "Pf") ch = 1;
  else return fail("not a PFM file");
  long w, h;
  std::string scale_tok;
  if (!next_int(f, &w) || !next_int(f, &h) || !next_token(f, &scale_tok))
    return fail("truncated PFM header");
  const double scale = strtod(scale_tok.c_str(), nullptr);
  const bool big_endian = scale > 0;
  const int64_t n = static_cast<int64_t>(w) * h * ch;
  if (out_size < n) return fail("output buffer too small");

  std::vector<float> row(static_cast<size_t>(w) * ch);
  // PFM rows are bottom-up: read row r into output row h-1-r.
  for (long r = 0; r < h; ++r) {
    if (fread(row.data(), 4, row.size(), f) != row.size())
      return fail("truncated PFM data");
    if (big_endian) {
      for (float& v : row) {
        uint32_t u;
        memcpy(&u, &v, 4);
        u = __builtin_bswap32(u);
        memcpy(&v, &u, 4);
      }
    }
    memcpy(out + static_cast<int64_t>(h - 1 - r) * w * ch, row.data(),
           row.size() * 4);
  }
  return 0;
}

STMIO_API int stmio_pfm_write(const char* path, const float* data,
                              int32_t width, int32_t height,
                              int32_t channels) {
  if (channels != 1 && channels != 3)
    return fail("PFM supports 1 or 3 channels");
  File f(path, "wb");
  if (!f) return fail(std::string("cannot open ") + path);
  fprintf(f, "%s\n%d %d\n-1.0\n", channels == 3 ? "PF" : "Pf", width, height);
  const size_t row_elems = static_cast<size_t>(width) * channels;
  for (int32_t r = height - 1; r >= 0; --r) {
    if (fwrite(data + static_cast<int64_t>(r) * row_elems, 4, row_elems, f)
        != row_elems)
      return fail("short write");
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Binary Netpbm: PGM (P5) and PPM (P6) — the Middlebury 2003 image format.
// ---------------------------------------------------------------------------

STMIO_API int stmio_pnm_probe(const char* path, int32_t* width,
                              int32_t* height, int32_t* channels,
                              int32_t* maxval) {
  File f(path, "rb");
  if (!f) return fail(std::string("cannot open ") + path);
  std::string magic;
  if (!next_token(f, &magic)) return fail("truncated PNM header");
  if (magic == "P5") *channels = 1;
  else if (magic == "P6") *channels = 3;
  else return fail("unsupported PNM magic '" + magic + "' (P5/P6 only)");
  long w, h, mv;
  if (!next_int(f, &w) || !next_int(f, &h) || !next_int(f, &mv))
    return fail("truncated PNM header");
  *width = static_cast<int32_t>(w);
  *height = static_cast<int32_t>(h);
  *maxval = static_cast<int32_t>(mv);
  return 0;
}

STMIO_API int stmio_pnm_read(const char* path, uint8_t* out,
                             int64_t out_size) {
  File f(path, "rb");
  if (!f) return fail(std::string("cannot open ") + path);
  std::string magic;
  if (!next_token(f, &magic)) return fail("truncated PNM header");
  int ch;
  if (magic == "P5") ch = 1;
  else if (magic == "P6") ch = 3;
  else return fail("unsupported PNM magic");
  long w, h, mv;
  if (!next_int(f, &w) || !next_int(f, &h) || !next_int(f, &mv))
    return fail("truncated PNM header");
  if (mv > 255) return fail("16-bit PNM not supported");
  const int64_t n = static_cast<int64_t>(w) * h * ch;
  if (out_size < n) return fail("output buffer too small");
  if (fread(out, 1, n, f) != static_cast<size_t>(n))
    return fail("truncated PNM data");
  return 0;
}

STMIO_API int stmio_pnm_write(const char* path, const uint8_t* data,
                              int32_t width, int32_t height,
                              int32_t channels) {
  if (channels != 1 && channels != 3)
    return fail("PNM supports 1 or 3 channels");
  File f(path, "wb");
  if (!f) return fail(std::string("cannot open ") + path);
  fprintf(f, "%s\n%d %d\n255\n", channels == 3 ? "P6" : "P5", width, height);
  const int64_t n = static_cast<int64_t>(width) * height * channels;
  if (fwrite(data, 1, n, f) != static_cast<size_t>(n))
    return fail("short write");
  return 0;
}

// ---------------------------------------------------------------------------
// YUV4MPEG2 (Y4M) stream reader + threaded prefetcher.
//
// The video-capture data path (reference: capture.py:36-98 over cv2).
// Y4M is the standard uncompressed interchange format (ffmpeg -f yuv4mpegpipe)
// so no codec dependencies are needed.  Only the luma plane is consumed —
// the stereo engine is grayscale-in (cli_video.py:96 converts anyway) — and
// chroma is skipped by seek, so 4:2:0/4:2:2/4:4:4/mono all work.
// ---------------------------------------------------------------------------

namespace {

struct Y4M {
  FILE* f = nullptr;
  int32_t width = 0;
  int32_t height = 0;
  int64_t chroma_bytes = 0;   // bytes to skip after each luma plane
  int32_t fps_num = 0, fps_den = 1;

  // Prefetch machinery (depth 0 = synchronous).
  std::thread worker;
  std::mutex mu;
  std::condition_variable cv_full, cv_empty;
  std::vector<std::vector<uint8_t>> ring;
  size_t head = 0, tail = 0, count = 0;
  bool eof = false, stop = false;

  ~Y4M() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stop = true;
    }
    cv_full.notify_all();
    cv_empty.notify_all();
    if (worker.joinable()) worker.join();
    if (f) fclose(f);
  }

  bool read_frame_sync(uint8_t* out) {
    // Frame header line: "FRAME...\n"
    char line[256];
    if (!fgets(line, sizeof line, f)) return false;
    if (strncmp(line, "FRAME", 5) != 0) return false;
    const int64_t luma = static_cast<int64_t>(width) * height;
    if (fread(out, 1, luma, f) != static_cast<size_t>(luma)) return false;
    if (chroma_bytes > 0 && fseek(f, chroma_bytes, SEEK_CUR) != 0)
      return false;
    return true;
  }

  void prefetch_loop() {
    for (;;) {
      std::vector<uint8_t> frame(static_cast<size_t>(width) * height);
      if (!read_frame_sync(frame.data())) {
        std::lock_guard<std::mutex> lock(mu);
        eof = true;
        cv_empty.notify_all();
        return;
      }
      std::unique_lock<std::mutex> lock(mu);
      cv_full.wait(lock, [&] { return count < ring.size() || stop; });
      if (stop) return;
      ring[tail] = std::move(frame);
      tail = (tail + 1) % ring.size();
      ++count;
      cv_empty.notify_one();
    }
  }
};

}  // namespace

STMIO_API int stmio_y4m_open(const char* path, int32_t prefetch_depth,
                             void** handle, int32_t* width, int32_t* height,
                             int32_t* fps_num, int32_t* fps_den) {
  auto y = std::make_unique<Y4M>();
  y->f = fopen(path, "rb");
  if (!y->f) return fail(std::string("cannot open ") + path);

  char line[1024];
  if (!fgets(line, sizeof line, y->f) ||
      strncmp(line, "YUV4MPEG2", 9) != 0)
    return fail("not a YUV4MPEG2 stream");

  std::string chroma = "420";
  for (char* tok = strtok(line + 9, " \n"); tok; tok = strtok(nullptr, " \n")) {
    switch (tok[0]) {
      case 'W': y->width = atoi(tok + 1); break;
      case 'H': y->height = atoi(tok + 1); break;
      case 'F': sscanf(tok + 1, "%d:%d", &y->fps_num, &y->fps_den); break;
      case 'C': chroma = tok + 1; break;
      default: break;   // interlacing/aspect/extensions ignored
    }
  }
  if (y->width <= 0 || y->height <= 0) return fail("bad Y4M geometry");

  const int64_t luma = static_cast<int64_t>(y->width) * y->height;
  if (chroma.rfind("420", 0) == 0) y->chroma_bytes = luma / 2;
  else if (chroma.rfind("422", 0) == 0) y->chroma_bytes = luma;
  else if (chroma.rfind("444", 0) == 0) y->chroma_bytes = 2 * luma;
  else if (chroma.rfind("mono", 0) == 0) y->chroma_bytes = 0;
  else return fail("unsupported Y4M chroma mode C" + chroma);

  *width = y->width;
  *height = y->height;
  *fps_num = y->fps_num;
  *fps_den = y->fps_den ? y->fps_den : 1;

  if (prefetch_depth > 0) {
    y->ring.resize(static_cast<size_t>(prefetch_depth));
    y->worker = std::thread(&Y4M::prefetch_loop, y.get());
  }
  *handle = y.release();
  return 0;
}

// Reads the next luma frame into out ([height * width] uint8, row-major).
// Returns 0 on success, 1 on end-of-stream, negative on error.
STMIO_API int stmio_y4m_read(void* handle, uint8_t* out) {
  auto* y = static_cast<Y4M*>(handle);
  if (y->ring.empty())
    return y->read_frame_sync(out) ? 0 : 1;
  std::unique_lock<std::mutex> lock(y->mu);
  y->cv_empty.wait(lock, [&] { return y->count > 0 || y->eof || y->stop; });
  if (y->count == 0) return 1;  // eof and ring drained
  std::vector<uint8_t> frame = std::move(y->ring[y->head]);
  y->head = (y->head + 1) % y->ring.size();
  --y->count;
  y->cv_full.notify_one();
  lock.unlock();
  memcpy(out, frame.data(), frame.size());
  return 0;
}

STMIO_API void stmio_y4m_close(void* handle) {
  delete static_cast<Y4M*>(handle);
}

// ---------------------------------------------------------------------------
// Y4M writer (mono) — lets tests and tools produce streams without ffmpeg.
// ---------------------------------------------------------------------------

STMIO_API int stmio_y4m_write(const char* path, const uint8_t* frames,
                              int32_t n_frames, int32_t width,
                              int32_t height, int32_t fps_num,
                              int32_t fps_den) {
  File f(path, "wb");
  if (!f) return fail(std::string("cannot open ") + path);
  fprintf(f, "YUV4MPEG2 W%d H%d F%d:%d Ip A1:1 Cmono\n", width, height,
          fps_num, fps_den);
  const int64_t luma = static_cast<int64_t>(width) * height;
  for (int32_t i = 0; i < n_frames; ++i) {
    fprintf(f, "FRAME\n");
    if (fwrite(frames + i * luma, 1, luma, f) != static_cast<size_t>(luma))
      return fail("short write");
  }
  return 0;
}
