// Native ETL: record readers + async batch prefetcher.
//
// Parity role: the reference's ETL runs in native/background threads —
// DataVec record readers (external dep of deeplearning4j-core
// datasets/datavec/) and AsyncDataSetIterator's prefetch thread
// (nn/.../datasets/iterator/AsyncDataSetIterator.java, used at
// MultiLayerNetwork.java:1161 — SURVEY.md §3.1 'thread boundary (ETL)').
// Python threads can't overlap CPU-bound parsing/assembly with the train
// loop (GIL); these C++ worker threads can.
//
// C API (ctypes-friendly): IDX (MNIST/EMNIST) and CSV readers materialize
// f32 feature/label arrays; the batcher owns a bounded queue filled by a
// worker thread doing shuffled gather+copy of minibatches.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ------------------------------------------------------------------ IDX
// Returns 0 on success. Query mode: pass null buffers, receive dims.
// Labels are one-hot encoded to n_classes (0 → raw label values, ydim=1).
int idx_load(const char* img_path, const char* lab_path, int n_classes,
             int64_t* out_n, int64_t* out_feat,
             float* x_out, float* y_out) {
  FILE* fi = fopen(img_path, "rb");
  if (!fi) return 1;
  unsigned char hdr[16];
  if (fread(hdr, 1, 16, fi) != 16 || hdr[0] != 0 || hdr[1] != 0 ||
      hdr[2] != 0x08 || hdr[3] != 0x03) {
    fclose(fi);
    return 2;  // not an idx3-ubyte file
  }
  auto be32 = [](unsigned char* p) {
    return (int64_t)((p[0] << 24) | (p[1] << 16) | (p[2] << 8) | p[3]);
  };
  int64_t n = be32(hdr + 4), rows = be32(hdr + 8), cols = be32(hdr + 12);
  int64_t feat = rows * cols;
  *out_n = n;
  *out_feat = feat;
  if (!x_out) {  // query mode
    fclose(fi);
    return 0;
  }
  std::vector<unsigned char> buf(feat);
  for (int64_t i = 0; i < n; i++) {
    if (fread(buf.data(), 1, feat, fi) != (size_t)feat) {
      fclose(fi);
      return 3;
    }
    float* dst = x_out + i * feat;
    for (int64_t j = 0; j < feat; j++) dst[j] = buf[j] * (1.0f / 255.0f);
  }
  fclose(fi);

  FILE* fl = fopen(lab_path, "rb");
  if (!fl) return 4;
  unsigned char lh[8];
  if (fread(lh, 1, 8, fl) != 8 || lh[2] != 0x08 || lh[3] != 0x01) {
    fclose(fl);
    return 5;
  }
  int64_t nl = be32(lh + 4);
  if (nl != n) {
    fclose(fl);
    return 6;
  }
  std::vector<unsigned char> labs(n);
  if (fread(labs.data(), 1, n, fl) != (size_t)n) {
    fclose(fl);
    return 7;
  }
  fclose(fl);
  if (n_classes > 0) {
    memset(y_out, 0, sizeof(float) * n * n_classes);
    for (int64_t i = 0; i < n; i++) {
      int lab = labs[i];
      if (lab >= 0 && lab < n_classes) y_out[i * n_classes + lab] = 1.0f;
    }
  } else {
    for (int64_t i = 0; i < n; i++) y_out[i] = (float)labs[i];
  }
  return 0;
}

// ------------------------------------------------------------------ CSV
// Two-phase: csv_dims counts rows/cols; csv_load fills x (all non-label
// columns) and y (label column one-hot to n_classes, or raw if 0).
// Lines longer than the 64 KiB buffer are an error (rc=8), not a silent
// row split; quoted fields / embedded delimiters are unsupported (the
// Python binding documents this).
static int line_truncated(const char* line, size_t cap, FILE* f) {
  size_t len = strlen(line);
  if (len != cap - 1 || line[len - 1] == '\n') return 0;
  // buffer full without newline: truncated unless this is the final line of
  // a file with no trailing newline
  int c = fgetc(f);
  if (c == EOF) return 0;
  ungetc(c, f);
  return 1;
}

int csv_dims(const char* path, int skip_lines, char delim,
             int64_t* out_rows, int64_t* out_cols) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  char line[1 << 16];
  int64_t rows = 0, cols = 0;
  int skipped = 0;
  while (fgets(line, sizeof(line), f)) {
    if (line_truncated(line, sizeof(line), f)) {
      fclose(f);
      return 8;
    }
    if (skipped < skip_lines) {
      skipped++;
      continue;
    }
    if (line[0] == '\n' || line[0] == '\r' || line[0] == 0) continue;
    if (cols == 0) {
      cols = 1;
      for (char* p = line; *p; p++)
        if (*p == delim) cols++;
    }
    rows++;
  }
  fclose(f);
  *out_rows = rows;
  *out_cols = cols;
  return 0;
}

int csv_load(const char* path, int skip_lines, char delim, int64_t n_cols,
             int label_col, int n_classes, float* x_out, float* y_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  char line[1 << 16];
  int skipped = 0;
  int64_t row = 0;
  int64_t n_feat = (label_col >= 0) ? n_cols - 1 : n_cols;
  while (fgets(line, sizeof(line), f)) {
    if (line_truncated(line, sizeof(line), f)) {
      fclose(f);
      return 8;
    }
    if (skipped < skip_lines) {
      skipped++;
      continue;
    }
    if (line[0] == '\n' || line[0] == '\r' || line[0] == 0) continue;
    int64_t col = 0, xcol = 0;
    char* p = line;
    while (*p && col < n_cols) {
      char* end;
      double v = strtod(p, &end);
      if (col == label_col) {
        if (n_classes > 0) {
          int lab = (int)v;
          for (int c = 0; c < n_classes; c++)
            y_out[row * n_classes + c] = (c == lab) ? 1.0f : 0.0f;
        } else {
          y_out[row] = (float)v;
        }
      } else {
        x_out[row * n_feat + xcol] = (float)v;
        xcol++;
      }
      col++;
      p = (end == p) ? p + 1 : end;
      while (*p && *p != delim) p++;
      if (*p == delim) p++;
    }
    row++;
  }
  fclose(f);
  return 0;
}

// --------------------------------------------------------------- batcher
struct Batch {
  std::vector<float> x, y;
  int64_t count;
};

struct Batcher {
  const float* x;
  const float* y;
  int64_t n, xdim, ydim;
  int64_t batch;
  bool shuffle;
  uint64_t seed;
  int64_t epoch;
  size_t capacity;

  std::vector<int64_t> order;
  std::queue<Batch*> q;
  std::mutex m;
  std::condition_variable cv_put, cv_get;
  std::thread worker;
  std::atomic<bool> stop{false};
  std::atomic<bool> epoch_done{false};

  void fill_order() {
    order.resize(n);
    for (int64_t i = 0; i < n; i++) order[i] = i;
    if (shuffle) {
      std::mt19937_64 rng(seed + (uint64_t)epoch);
      for (int64_t i = n - 1; i > 0; i--) {
        int64_t j = (int64_t)(rng() % (uint64_t)(i + 1));
        std::swap(order[i], order[j]);
      }
    }
  }

  void run() {
    fill_order();
    for (int64_t start = 0; start < n && !stop; start += batch) {
      int64_t cnt = std::min(batch, n - start);
      Batch* b = new Batch();
      b->count = cnt;
      b->x.resize(cnt * xdim);
      b->y.resize(cnt * ydim);
      for (int64_t i = 0; i < cnt; i++) {
        int64_t src = order[start + i];
        memcpy(b->x.data() + i * xdim, x + src * xdim,
               sizeof(float) * xdim);
        memcpy(b->y.data() + i * ydim, y + src * ydim,
               sizeof(float) * ydim);
      }
      std::unique_lock<std::mutex> lk(m);
      cv_put.wait(lk, [&] { return q.size() < capacity || stop; });
      if (stop) {
        delete b;
        return;
      }
      q.push(b);
      cv_get.notify_one();
    }
    epoch_done = true;
    cv_get.notify_all();
  }
};

void* batcher_create(const float* x, const float* y, int64_t n,
                     int64_t xdim, int64_t ydim, int64_t batch,
                     int shuffle, uint64_t seed, int capacity) {
  Batcher* b = new Batcher();
  b->x = x;
  b->y = y;
  b->n = n;
  b->xdim = xdim;
  b->ydim = ydim;
  b->batch = batch;
  b->shuffle = shuffle != 0;
  b->seed = seed;
  b->epoch = 0;
  b->capacity = capacity > 0 ? capacity : 4;
  b->worker = std::thread([b] { b->run(); });
  return b;
}

// Returns examples in this batch, 0 when the epoch is exhausted.
int64_t batcher_next(void* h, float* x_out, float* y_out) {
  Batcher* b = (Batcher*)h;
  std::unique_lock<std::mutex> lk(b->m);
  b->cv_get.wait(lk, [&] { return !b->q.empty() || b->epoch_done || b->stop; });
  if (b->q.empty()) return 0;
  Batch* batch = b->q.front();
  b->q.pop();
  b->cv_put.notify_one();
  lk.unlock();
  memcpy(x_out, batch->x.data(), sizeof(float) * batch->count * b->xdim);
  memcpy(y_out, batch->y.data(), sizeof(float) * batch->count * b->ydim);
  int64_t cnt = batch->count;
  delete batch;
  return cnt;
}

// New epoch: re-shuffles with seed+epoch and restarts the worker.
void batcher_reset(void* h) {
  Batcher* b = (Batcher*)h;
  {
    std::unique_lock<std::mutex> lk(b->m);
    b->stop = true;
    b->cv_put.notify_all();
    b->cv_get.notify_all();
  }
  if (b->worker.joinable()) b->worker.join();
  std::queue<Batch*> empty;
  while (!b->q.empty()) {
    delete b->q.front();
    b->q.pop();
  }
  b->stop = false;
  b->epoch_done = false;
  b->epoch++;
  b->worker = std::thread([b] { b->run(); });
}

void batcher_destroy(void* h) {
  Batcher* b = (Batcher*)h;
  {
    std::unique_lock<std::mutex> lk(b->m);
    b->stop = true;
    b->cv_put.notify_all();
    b->cv_get.notify_all();
  }
  if (b->worker.joinable()) b->worker.join();
  while (!b->q.empty()) {
    delete b->q.front();
    b->q.pop();
  }
  delete b;
}

}  // extern "C"
