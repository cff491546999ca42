// Threaded frame-stream prefetcher.
//
// The port's own copy of the JAX package's framework-free source.
// Native counterpart of the reference implementation's host-side data path
// (image load + float conversion feeding the device): a worker pool
// decodes frames ahead of the consumer into preallocated float32 BGR
// buffers so device steps never wait on PNG/JPEG decode.
//
// C ABI: create a stream over a list of paths; ``stream_next`` blocks
// until the next frame (in order) is ready and copies it into the
// caller's buffer.

#include <atomic>
#include <condition_variable>
#include <cstring>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

extern "C" int image_read_bgr32f(const char* path, int* width, int* height,
                                 float* data);

namespace {

struct Slot {
  std::vector<float> data;
  int width = 0, height = 0;
  int status = 0;  // 0 = pending, 1 = ready, <0 = error
};

struct FrameStream {
  std::vector<std::string> paths;
  std::vector<Slot> slots;
  std::atomic<size_t> next_decode{0};
  size_t next_consume = 0;
  size_t window = 0;  // decode at most this far ahead of consumption
  std::mutex mu;
  std::condition_variable cv;
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    while (!stop.load()) {
      size_t idx = next_decode.fetch_add(1);
      if (idx >= paths.size()) return;
      {
        // bound read-ahead so memory stays ~window frames
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] {
          return stop.load() || idx < next_consume + window;
        });
        if (stop.load()) return;
      }
      Slot& s = slots[idx];
      int w = 0, h = 0;
      int rc = image_read_bgr32f(paths[idx].c_str(), &w, &h, nullptr);
      if (rc == 0) {
        s.data.resize((size_t)w * h * 3);
        rc = image_read_bgr32f(paths[idx].c_str(), &w, &h, s.data.data());
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        s.width = w;
        s.height = h;
        s.status = rc == 0 ? 1 : rc;
      }
      cv.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* stream_open(const char** paths, int n_paths, int n_threads,
                  int read_ahead) {
  auto* fs = new FrameStream();
  fs->paths.assign(paths, paths + n_paths);
  fs->slots.resize(n_paths);
  fs->window = read_ahead > 0 ? (size_t)read_ahead : 8;
  int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; i++)
    fs->workers.emplace_back(&FrameStream::worker, fs);
  return fs;
}

// Blocks for the next frame; returns 0 and fills (width, height, data).
// data must hold max_floats floats; returns -100 if too small, -99 at EOF.
int stream_next(void* handle, int* width, int* height, float* data,
                long max_floats) {
  auto* fs = (FrameStream*)handle;
  if (fs->next_consume >= fs->paths.size()) return -99;
  size_t idx = fs->next_consume;
  Slot& s = fs->slots[idx];
  {
    std::unique_lock<std::mutex> lk(fs->mu);
    fs->cv.wait(lk, [&] { return s.status != 0; });
  }
  if (s.status < 0) return s.status;
  long need = (long)s.width * s.height * 3;
  if (need > max_floats) return -100;
  *width = s.width;
  *height = s.height;
  std::memcpy(data, s.data.data(), (size_t)need * sizeof(float));
  {
    std::lock_guard<std::mutex> lk(fs->mu);
    s.data.clear();
    s.data.shrink_to_fit();
    fs->next_consume = idx + 1;
  }
  fs->cv.notify_all();
  return 0;
}

void stream_close(void* handle) {
  auto* fs = (FrameStream*)handle;
  fs->stop.store(true);
  fs->cv.notify_all();
  for (auto& t : fs->workers) t.join();
  delete fs;
}

}  // extern "C"
