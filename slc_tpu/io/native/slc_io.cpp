// Native I/O for slc_tpu: BMP codec + fast ASCII point-cloud writer.
//
// Replacement for the runtime roles OpenCV played in the
// reference: cv::imread of dataset BMPs (DynaFrame/CSensorV.cpp:111-114),
// cv::imwrite archival (DynaFrame/CStorage.cpp:41-55), and the per-frame
// ofstream point-cloud dumps (DynaFrame/CCalculation.cpp:323-357) whose
// iostream formatting dominates frame time at 1.3 MP. Exposed as a C ABI
// for ctypes; the Python wrappers fall back to numpy implementations when
// this library is absent.
//
// Build: g++ -O3 -march=native -shared -fPIC slc_io.cpp -o libslc_io.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

#pragma pack(push, 1)
struct BmpFileHeader {
  uint16_t magic;
  uint32_t file_size;
  uint32_t reserved;
  uint32_t data_offset;
};
struct BmpInfoHeader {
  uint32_t header_size;
  int32_t width;
  int32_t height;
  uint16_t planes;
  uint16_t bpp;
  uint32_t compression;
  uint32_t image_size;
  int32_t ppm_x, ppm_y;
  uint32_t colors_used, colors_important;
};
#pragma pack(pop)

inline int row_stride(int width, int bpp) {
  return (width * bpp / 8 + 3) & ~3;
}

// Fast float -> ascii with fixed precision (7 decimals), ~6x faster
// than snprintf("%.7f").
inline char* fmt_fixed7(char* p, double v) {
  if (v < 0) { *p++ = '-'; v = -v; }
  uint64_t scaled = (uint64_t)(v * 1e7 + 0.5);
  uint64_t ip = scaled / 10000000ULL;
  uint64_t fp = scaled % 10000000ULL;
  char tmp[24];
  int n = 0;
  do { tmp[n++] = '0' + (char)(ip % 10); ip /= 10; } while (ip);
  while (n) *p++ = tmp[--n];
  *p++ = '.';
  for (int d = 6; d >= 0; --d) {
    p[d] = '0' + (char)(fp % 10);
    fp /= 10;
  }
  return p + 7;
}

}  // namespace

extern "C" {

// Reads header only; returns 0 on success and fills (h, w, bpp).
int slc_bmp_probe(const char* path, int* h, int* w, int* bpp) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  BmpFileHeader fh;
  BmpInfoHeader ih;
  if (fread(&fh, sizeof fh, 1, f) != 1 || fh.magic != 0x4D42 ||
      fread(&ih, sizeof ih, 1, f) != 1 || ih.compression != 0) {
    fclose(f);
    return -2;
  }
  *h = ih.height < 0 ? -ih.height : ih.height;
  *w = ih.width;
  *bpp = ih.bpp;
  fclose(f);
  return 0;
}

// Reads an 8/24/32-bit uncompressed BMP as grayscale into out (h*w,
// row-major, top-down). Returns 0 on success.
int slc_bmp_read_gray(const char* path, uint8_t* out, int out_h,
                      int out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  BmpFileHeader fh;
  BmpInfoHeader ih;
  if (fread(&fh, sizeof fh, 1, f) != 1 || fh.magic != 0x4D42 ||
      fread(&ih, sizeof ih, 1, f) != 1 || ih.compression != 0) {
    fclose(f);
    return -2;
  }
  const int h = ih.height < 0 ? -ih.height : ih.height;
  const int w = ih.width;
  const bool bottom_up = ih.height > 0;
  if (h != out_h || w != out_w) {
    fclose(f);
    return -3;
  }

  uint8_t pal_lum[256];
  bool pal_identity = true;
  if (ih.bpp == 8) {
    const int n_pal = ih.colors_used ? (int)ih.colors_used : 256;
    uint8_t pal[256 * 4];
    if (fseek(f, sizeof fh + ih.header_size, SEEK_SET) != 0 ||
        fread(pal, 4, n_pal, f) != (size_t)n_pal) {
      fclose(f);
      return -4;
    }
    for (int i = 0; i < n_pal; ++i) {
      const uint8_t b = pal[4 * i], g = pal[4 * i + 1], r = pal[4 * i + 2];
      // OpenCV/ITU-R 601 grayscale weights (matches cv::imread gray).
      pal_lum[i] =
          (uint8_t)((1868 * b + 9617 * g + 4899 * r + 8192) >> 14);
      if (b != g || g != r || b != (uint8_t)i) pal_identity = false;
      if (pal_lum[i] != (uint8_t)i) pal_identity = pal_identity && false;
    }
  }

  const int stride = row_stride(w, ih.bpp);
  uint8_t* row = (uint8_t*)malloc(stride);
  if (!row) { fclose(f); return -5; }
  if (fseek(f, fh.data_offset, SEEK_SET) != 0) {
    free(row);
    fclose(f);
    return -4;
  }
  for (int i = 0; i < h; ++i) {
    if (fread(row, 1, stride, f) != (size_t)stride) {
      free(row);
      fclose(f);
      return -4;
    }
    uint8_t* dst = out + (size_t)(bottom_up ? h - 1 - i : i) * w;
    if (ih.bpp == 8) {
      if (pal_identity) {
        memcpy(dst, row, w);
      } else {
        for (int j = 0; j < w; ++j) dst[j] = pal_lum[row[j]];
      }
    } else if (ih.bpp == 24 || ih.bpp == 32) {
      const int c = ih.bpp / 8;
      for (int j = 0; j < w; ++j) {
        const uint8_t b = row[c * j], g = row[c * j + 1],
                      r = row[c * j + 2];
        dst[j] = (uint8_t)((1868 * b + 9617 * g + 4899 * r + 8192) >> 14);
      }
    } else {
      free(row);
      fclose(f);
      return -6;
    }
  }
  free(row);
  fclose(f);
  return 0;
}

// Writes (h, w) top-down grayscale as an 8-bit palette BMP.
int slc_bmp_write_gray(const char* path, const uint8_t* img, int h,
                       int w) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const int stride = row_stride(w, 8);
  BmpFileHeader fh;
  BmpInfoHeader ih;
  memset(&ih, 0, sizeof ih);
  const uint32_t data_offset = sizeof fh + sizeof ih + 256 * 4;
  fh.magic = 0x4D42;
  fh.file_size = data_offset + stride * h;
  fh.reserved = 0;
  fh.data_offset = data_offset;
  ih.header_size = sizeof ih;
  ih.width = w;
  ih.height = h;  // bottom-up
  ih.planes = 1;
  ih.bpp = 8;
  ih.image_size = stride * h;
  ih.ppm_x = ih.ppm_y = 2835;
  ih.colors_used = 256;
  uint8_t pal[256 * 4];
  for (int i = 0; i < 256; ++i) {
    pal[4 * i] = pal[4 * i + 1] = pal[4 * i + 2] = (uint8_t)i;
    pal[4 * i + 3] = 0;
  }
  uint8_t* row = (uint8_t*)calloc(1, stride);
  int ok = fwrite(&fh, sizeof fh, 1, f) == 1 &&
           fwrite(&ih, sizeof ih, 1, f) == 1 &&
           fwrite(pal, 1, sizeof pal, f) == sizeof pal;
  for (int i = h - 1; ok && i >= 0; --i) {
    memcpy(row, img + (size_t)i * w, w);
    ok = fwrite(row, 1, stride, f) == (size_t)stride;
  }
  free(row);
  fclose(f);
  return ok ? 0 : -2;
}

// Writes "x y z\n" lines for pixels where z > 0 (the reference's
// per-frame result dump, CCalculation.cpp:341-350). Returns the number
// of points written, or <0 on error.
long slc_write_xyz(const char* path, const float* x, const float* y,
                   const float* z, long n) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  const size_t BUF = 1 << 20;
  char* buf = (char*)malloc(BUF);
  if (!buf) { fclose(f); return -2; }
  char* p = buf;
  long count = 0;
  for (long i = 0; i < n; ++i) {
    if (!(z[i] > 0.0f)) continue;
    if ((size_t)(p - buf) > BUF - 128) {
      fwrite(buf, 1, p - buf, f);
      p = buf;
    }
    p = fmt_fixed7(p, x[i]);
    *p++ = ' ';
    p = fmt_fixed7(p, y[i]);
    *p++ = ' ';
    p = fmt_fixed7(p, z[i]);
    *p++ = '\n';
    ++count;
  }
  fwrite(buf, 1, p - buf, f);
  free(buf);
  fclose(f);
  return count;
}

}  // extern "C"

// ------------------------------------------------------------------
// Threaded prefetch loader: decodes a fixed list of grayscale BMPs with
// a worker pool into a ring of preallocated slots, delivering frames to
// the (single) consumer strictly in order. This is the runtime role the
// reference fills with one synchronous cv::imread per dynamic frame
// inside the tracking loop (DynaFrame/CSensorV.cpp:111-114,
// CCalculation.cpp:791-795); here decode parallelism and read-ahead
// hide disk + decode latency under device compute. Single-consumer
// contract: slc_loader_next must not be called concurrently.

struct SlcLoader {
  std::vector<std::string> paths;
  int h, w, slots;
  std::vector<uint8_t> ring;     // slots * h * w
  std::vector<long> slot_frame;  // frame occupying the slot, -1 = free
  std::vector<int> slot_state;   // 0 free, 1 decoding, 2 ready
  std::vector<int> slot_err;
  long next_job = 0;   // next frame index a worker will decode
  long next_out = 0;   // next frame index the consumer receives
  bool stop = false;
  std::mutex m;
  std::condition_variable cv;
  std::vector<std::thread> workers;
};

static void slc_loader_worker(SlcLoader* L) {
  for (;;) {
    long job;
    int s;
    {
      std::unique_lock<std::mutex> lk(L->m);
      for (;;) {
        if (L->stop) return;
        if (L->next_job >= (long)L->paths.size()) return;
        s = (int)(L->next_job % L->slots);
        if (L->slot_state[s] == 0) break;  // ring slot for this job free
        L->cv.wait(lk);
      }
      job = L->next_job++;
      L->slot_state[s] = 1;
      L->slot_frame[s] = job;
      L->cv.notify_all();  // other workers re-check their target slot
    }
    const int err = slc_bmp_read_gray(
        L->paths[job].c_str(),
        L->ring.data() + (size_t)s * L->h * L->w, L->h, L->w);
    {
      std::lock_guard<std::mutex> lk(L->m);
      L->slot_state[s] = 2;
      L->slot_err[s] = err;
      L->cv.notify_all();
    }
  }
}

extern "C" {

// Creates a loader over n paths of (h, w) grayscale BMPs. slots is the
// read-ahead ring depth, threads the decode pool size. Returns NULL on
// bad arguments.
void* slc_loader_create(const char** paths, long n, int h, int w,
                        int slots, int threads) {
  if (n <= 0 || h <= 0 || w <= 0) return nullptr;
  if (slots < 1) slots = 1;
  if (threads < 1) threads = 1;
  if (threads > slots) threads = slots;
  SlcLoader* L = new SlcLoader();
  L->paths.reserve(n);
  for (long i = 0; i < n; ++i) L->paths.emplace_back(paths[i]);
  L->h = h;
  L->w = w;
  L->slots = slots;
  L->ring.resize((size_t)slots * h * w);
  L->slot_frame.assign(slots, -1);
  L->slot_state.assign(slots, 0);
  L->slot_err.assign(slots, 0);
  for (int t = 0; t < threads; ++t)
    L->workers.emplace_back(slc_loader_worker, L);
  return L;
}

// Copies the next frame (in submission order) into out (h*w bytes).
// Returns 0 on success, 1 at end-of-stream, <0 if THIS frame failed to
// decode (the stream continues; out is untouched).
int slc_loader_next(void* hp, uint8_t* out) {
  SlcLoader* L = (SlcLoader*)hp;
  std::unique_lock<std::mutex> lk(L->m);
  if (L->next_out >= (long)L->paths.size()) return 1;
  const int s = (int)(L->next_out % L->slots);
  L->cv.wait(lk, [&] {
    return L->slot_state[s] == 2 && L->slot_frame[s] == L->next_out;
  });
  const int err = L->slot_err[s];
  if (err == 0) {
    // Slot stays state 2 / owned by next_out while unlocked: no worker
    // claims a non-free slot and there is a single consumer.
    lk.unlock();
    memcpy(out, L->ring.data() + (size_t)s * L->h * L->w,
           (size_t)L->h * L->w);
    lk.lock();
  }
  L->slot_state[s] = 0;
  L->slot_frame[s] = -1;
  L->next_out++;
  L->cv.notify_all();
  return err;
}

void slc_loader_destroy(void* hp) {
  SlcLoader* L = (SlcLoader*)hp;
  {
    std::lock_guard<std::mutex> lk(L->m);
    L->stop = true;
    L->cv.notify_all();
  }
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
