// Native runtime of the PyTorch/CUDA port: binary PPM/PGM codec and a
// multithreaded batch prefetch loader (a copy of the JAX package's
// runtime/native/mcim_runtime.cpp; the port builds and loads its own).
//
// The reference's runtime layer is native C++ throughout (OpenCV I/O at
// kern.cpp:33,92 / kernel.cu:110,236; MPI; CUDA memory management). The
// host I/O path stays native here: uncompressed PPM/PGM decode is a
// straight memcpy that Python/PIL overhead dominates, and the batch loader
// overlaps disk reads with device compute (double-buffering at the host
// level, the counterpart of the reference's cudaMemcpy staging at
// kernel.cu:163,202).
//
// Exposed C ABI (bound via ctypes in runtime/codec.py):
//   mcim_read_header(path, &h, &w, &c)            -> 0 on success
//   mcim_read_image(path, buf, buf_size)          -> 0 on success
//   mcim_write_image(path, buf, h, w, c)          -> 0 on success
//   mcim_loader_create(paths, n, n_threads)       -> handle (>=0) or -1
//   mcim_loader_next(handle, buf, cap, &idx,&h,&w,&c) -> 1 item, 0 done, <0 err
//   mcim_loader_destroy(handle)
//   mcim_version()                                -> int

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int kVersion = 1;

struct Image {
  int h = 0, w = 0, c = 0;
  std::vector<uint8_t> data;
};

// ---- PPM/PGM (binary P5/P6, maxval <= 255) ----

bool read_pnm_header(FILE* f, int* h, int* w, int* c) {
  char magic[3] = {0};
  if (fscanf(f, "%2s", magic) != 1) return false;
  int channels;
  if (strcmp(magic, "P6") == 0) {
    channels = 3;
  } else if (strcmp(magic, "P5") == 0) {
    channels = 1;
  } else {
    return false;
  }
  // skip whitespace + comments between tokens
  auto next_int = [&](int* out) -> bool {
    int ch;
    while ((ch = fgetc(f)) != EOF) {
      if (ch == '#') {
        while ((ch = fgetc(f)) != EOF && ch != '\n') {
        }
      } else if (!isspace(ch)) {
        ungetc(ch, f);
        break;
      }
    }
    return fscanf(f, "%d", out) == 1;
  };
  int width, height, maxval;
  if (!next_int(&width) || !next_int(&height) || !next_int(&maxval)) return false;
  if (width <= 0 || height <= 0 || maxval <= 0 || maxval > 255) return false;
  int ch = fgetc(f);  // single whitespace before raster
  if (ch == EOF) return false;
  *h = height;
  *w = width;
  *c = channels;
  return true;
}

bool read_pnm(const char* path, Image* img) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  int h, w, c;
  if (!read_pnm_header(f, &h, &w, &c)) {
    fclose(f);
    return false;
  }
  size_t n = static_cast<size_t>(h) * w * c;
  img->h = h;
  img->w = w;
  img->c = c;
  img->data.resize(n);
  bool ok = fread(img->data.data(), 1, n, f) == n;
  fclose(f);
  return ok;
}

bool write_pnm(const char* path, const uint8_t* buf, int h, int w, int c) {
  if (c != 1 && c != 3) return false;
  FILE* f = fopen(path, "wb");
  if (!f) return false;
  fprintf(f, "%s\n%d %d\n255\n", c == 3 ? "P6" : "P5", w, h);
  size_t n = static_cast<size_t>(h) * w * c;
  bool ok = fwrite(buf, 1, n, f) == n;
  fclose(f);
  return ok;
}

// ---- batch prefetch loader ----

struct Loader {
  std::vector<std::string> paths;
  std::vector<std::thread> workers;
  std::atomic<size_t> next_job{0};
  std::map<size_t, Image> ready;  // decoded, awaiting delivery in order
  size_t next_deliver = 0;
  size_t max_ahead = 16;  // bound memory: decode at most this far ahead
  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for next_deliver
  std::condition_variable cv_window;  // workers wait for the window to move
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      if (stop.load()) return;
      size_t idx = next_job.fetch_add(1);
      if (idx >= paths.size()) return;
      {
        // stay within the prefetch window
        std::unique_lock<std::mutex> lock(mu);
        cv_window.wait(lock, [&] {
          return stop.load() || idx < next_deliver + max_ahead;
        });
        if (stop.load()) return;
      }
      Image img;
      bool ok = read_pnm(paths[idx].c_str(), &img);
      {
        std::lock_guard<std::mutex> lock(mu);
        if (!ok) img = Image{};  // deliver an empty record; python raises
        ready.emplace(idx, std::move(img));
      }
      cv_ready.notify_all();
    }
  }
};

std::mutex g_loaders_mu;
std::map<int64_t, std::unique_ptr<Loader>> g_loaders;
int64_t g_next_handle = 1;

}  // namespace

extern "C" {

int mcim_version() { return kVersion; }

int mcim_read_header(const char* path, int* h, int* w, int* c) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  bool ok = read_pnm_header(f, h, w, c);
  fclose(f);
  return ok ? 0 : -2;
}

int mcim_read_image(const char* path, uint8_t* buf, size_t buf_size) {
  Image img;
  if (!read_pnm(path, &img)) return -1;
  if (img.data.size() != buf_size) return -2;
  memcpy(buf, img.data.data(), buf_size);
  return 0;
}

int mcim_write_image(const char* path, const uint8_t* buf, int h, int w, int c) {
  return write_pnm(path, buf, h, w, c) ? 0 : -1;
}

int64_t mcim_loader_create(const char** paths, int n, int n_threads) {
  if (n < 0 || n_threads <= 0) return -1;
  auto loader = std::make_unique<Loader>();
  loader->paths.assign(paths, paths + n);
  int threads = std::min<int>(n_threads, std::max(1, n));
  for (int i = 0; i < threads; i++) {
    loader->workers.emplace_back(&Loader::worker, loader.get());
  }
  std::lock_guard<std::mutex> lock(g_loaders_mu);
  int64_t handle = g_next_handle++;
  g_loaders.emplace(handle, std::move(loader));
  return handle;
}

// Delivers images strictly in input order. Returns 1 with the image copied
// into buf (or, if cap is too small, returns -3 and only fills h/w/c so the
// caller can retry with a bigger buffer), 0 when the batch is exhausted,
// negative on error. A decode failure delivers h=w=c=0 for that index.
int mcim_loader_next(int64_t handle, uint8_t* buf, size_t cap, int* idx,
                     int* h, int* w, int* c) {
  Loader* loader;
  {
    std::lock_guard<std::mutex> lock(g_loaders_mu);
    auto it = g_loaders.find(handle);
    if (it == g_loaders.end()) return -1;
    loader = it->second.get();
  }
  std::unique_lock<std::mutex> lock(loader->mu);
  if (loader->next_deliver >= loader->paths.size()) return 0;
  size_t want = loader->next_deliver;
  loader->cv_ready.wait(lock, [&] { return loader->ready.count(want) > 0; });
  Image& img = loader->ready[want];
  *idx = static_cast<int>(want);
  *h = img.h;
  *w = img.w;
  *c = img.c;
  size_t n = img.data.size();
  if (n > cap) return -3;  // caller re-reads header and retries
  if (n > 0) memcpy(buf, img.data.data(), n);
  loader->ready.erase(want);
  loader->next_deliver++;
  loader->cv_window.notify_all();
  return 1;
}

void mcim_loader_destroy(int64_t handle) {
  std::unique_ptr<Loader> loader;
  {
    std::lock_guard<std::mutex> lock(g_loaders_mu);
    auto it = g_loaders.find(handle);
    if (it == g_loaders.end()) return;
    loader = std::move(it->second);
    g_loaders.erase(it);
  }
  loader->stop.store(true);
  loader->cv_window.notify_all();
  for (auto& t : loader->workers) t.join();
}

}  // extern "C"
