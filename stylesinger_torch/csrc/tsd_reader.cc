// TSD ("tensor shard data") native reader + batch assembler: the port's own
// copy of native/tsd_reader.cc, built at first use with the host C++
// compiler by stylesinger_torch/data/native_loader.py (plain C++17, no
// CUDA, no PyTorch headers).  It differs in two places: a shard whose data
// file is empty opens, and a gather starts threads only for at least 2 MB
// of copies (one thread per MB).
//
// Role: the hot IO path of the training data pipeline. The binarizer
// emits a flat tensor-table format (.tsidx/.tsdata) next to the pickled
// IndexedDataset shards, and this reader serves it zero-copy from an mmap
// with multithreaded padded-batch assembly: no pickling, no worker
// processes, no GIL on the copy path.
//
// Format (all little-endian int64 unless noted):
//   .tsidx: magic "TSD1" (4 bytes) | n_items |
//           per item: n_fields |
//             per field: name_len | name bytes | dtype_code | ndim |
//                        shape[ndim] | data_offset | nbytes
//   .tsdata: raw contiguous array bytes, 64-byte aligned per field.
//
// dtype codes: 0=f32 1=f64 2=i32 3=i64 4=i16 5=u8 6=bool
//
// C API (ctypes-friendly): every function is extern "C"; handles are
// opaque pointers.

#include <algorithm>
#include <cstdio>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Field {
  int64_t dtype;
  int64_t ndim;
  int64_t shape[8];
  int64_t offset;
  int64_t nbytes;
};

struct Item {
  std::unordered_map<std::string, Field> fields;
};

struct Shard {
  int data_fd = -1;
  const uint8_t* data = nullptr;
  size_t data_size = 0;
  std::vector<Item> items;
};

constexpr int64_t kBytesPerThread = 1 << 20;

int64_t rd_i64(const uint8_t*& p) {
  int64_t v;
  std::memcpy(&v, p, 8);
  p += 8;
  return v;
}

}  // namespace

extern "C" {

void* tsd_open(const char* idx_path, const char* data_path) {
  // read index fully
  FILE* f = fopen(idx_path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long idx_size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> idx(idx_size);
  if (fread(idx.data(), 1, idx_size, f) != (size_t)idx_size) {
    fclose(f);
    return nullptr;
  }
  fclose(f);
  const uint8_t* p = idx.data();
  if (idx_size < 12 || std::memcmp(p, "TSD1", 4) != 0) return nullptr;
  p += 4;
  auto shard = new Shard();
  int64_t n_items = rd_i64(p);
  shard->items.resize(n_items);
  for (int64_t i = 0; i < n_items; ++i) {
    int64_t n_fields = rd_i64(p);
    for (int64_t j = 0; j < n_fields; ++j) {
      int64_t name_len = rd_i64(p);
      std::string name(reinterpret_cast<const char*>(p), name_len);
      p += name_len;
      Field fld{};
      fld.dtype = rd_i64(p);
      fld.ndim = rd_i64(p);
      for (int64_t d = 0; d < fld.ndim; ++d) fld.shape[d] = rd_i64(p);
      fld.offset = rd_i64(p);
      fld.nbytes = rd_i64(p);
      shard->items[i].fields.emplace(std::move(name), fld);
    }
  }
  // mmap the data file
  shard->data_fd = open(data_path, O_RDONLY);
  if (shard->data_fd < 0) {
    delete shard;
    return nullptr;
  }
  struct stat st;
  fstat(shard->data_fd, &st);
  shard->data_size = st.st_size;
  if (shard->data_size == 0) return shard;  // a shard of empty items
  shard->data = static_cast<const uint8_t*>(
      mmap(nullptr, shard->data_size, PROT_READ, MAP_PRIVATE,
           shard->data_fd, 0));
  if (shard->data == MAP_FAILED) {
    close(shard->data_fd);
    delete shard;
    return nullptr;
  }
  return shard;
}

void tsd_close(void* h) {
  auto shard = static_cast<Shard*>(h);
  if (!shard) return;
  if (shard->data) munmap(const_cast<uint8_t*>(shard->data),
                          shard->data_size);
  if (shard->data_fd >= 0) close(shard->data_fd);
  delete shard;
}

int64_t tsd_num_items(void* h) {
  return static_cast<Shard*>(h)->items.size();
}

// Fill dtype/ndim/shape/nbytes for (item, field). Returns 0 on success.
int tsd_field_info(void* h, int64_t item, const char* name, int64_t* dtype,
                   int64_t* ndim, int64_t* shape8, int64_t* nbytes) {
  auto shard = static_cast<Shard*>(h);
  if (item < 0 || item >= (int64_t)shard->items.size()) return -1;
  auto it = shard->items[item].fields.find(name);
  if (it == shard->items[item].fields.end()) return -2;
  const Field& f = it->second;
  *dtype = f.dtype;
  *ndim = f.ndim;
  for (int d = 0; d < 8; ++d) shape8[d] = d < f.ndim ? f.shape[d] : 0;
  *nbytes = f.nbytes;
  return 0;
}

// Copy one field into out (exactly nbytes). Returns 0 on success.
int tsd_read_field(void* h, int64_t item, const char* name, uint8_t* out) {
  auto shard = static_cast<Shard*>(h);
  if (item < 0 || item >= (int64_t)shard->items.size()) return -1;
  auto it = shard->items[item].fields.find(name);
  if (it == shard->items[item].fields.end()) return -2;
  const Field& f = it->second;
  std::memcpy(out, shard->data + f.offset, f.nbytes);
  return 0;
}

// Gather a batch of items' field into a preallocated padded buffer
// [n, max_rows, row_bytes/elem...] flattened as bytes: out[i] starts at
// i * max_rows * row_bytes. Rows beyond the item's leading dim stay as-is
// (caller pre-zeros). Multithreaded memcpy. Returns 0, or -k for the
// first failing item position.
int tsd_gather_pad(void* h, const int64_t* items, int64_t n,
                   const char* name, uint8_t* out, int64_t max_rows,
                   int64_t row_bytes, int n_threads) {
  auto shard = static_cast<Shard*>(h);
  std::atomic<int> err{0};
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int64_t idx = items[i];
      if (idx < 0 || idx >= (int64_t)shard->items.size()) {
        err.store(-(int)(i + 1));
        return;
      }
      auto it = shard->items[idx].fields.find(name);
      if (it == shard->items[idx].fields.end()) {
        err.store(-(int)(i + 1));
        return;
      }
      const Field& f = it->second;
      int64_t rows = f.ndim > 0 ? f.shape[0] : 1;
      if (rows > max_rows) rows = max_rows;
      int64_t copy_bytes = rows * row_bytes;
      if (copy_bytes > f.nbytes) copy_bytes = f.nbytes;
      std::memcpy(out + i * max_rows * row_bytes, shard->data + f.offset,
                  copy_bytes);
    }
  };
  // Threads pay only where there is much to copy: starting one costs
  // about as much as copying a few hundred KB, so small gathers (tokens,
  // note streams, embeddings of a few items) copy on the calling thread.
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t idx = items[i];
    if (idx < 0 || idx >= (int64_t)shard->items.size()) continue;
    auto it = shard->items[idx].fields.find(name);
    if (it != shard->items[idx].fields.end())
      total += std::min<int64_t>(it->second.nbytes, max_rows * row_bytes);
  }
  int64_t by_size = total / kBytesPerThread;
  if (n_threads <= 1 || n < 4 || by_size < 2) {
    work(0, n);
  } else {
    int64_t nt = std::min<int64_t>(std::min<int64_t>(n_threads, n), by_size);
    std::vector<std::thread> threads;
    int64_t chunk = (n + nt - 1) / nt;
    for (int64_t t = 0; t < nt; ++t) {
      int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
      if (lo >= hi) break;
      threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
  }
  return err.load();
}

// Advise the kernel to prefetch the byte ranges of the given items
// (overlaps IO with compute for the next batch).
void tsd_prefetch(void* h, const int64_t* items, int64_t n) {
  auto shard = static_cast<Shard*>(h);
  long pagesz = sysconf(_SC_PAGESIZE);
  for (int64_t i = 0; i < n; ++i) {
    int64_t idx = items[i];
    if (idx < 0 || idx >= (int64_t)shard->items.size()) continue;
    for (const auto& kv : shard->items[idx].fields) {
      const Field& f = kv.second;
      uintptr_t start = reinterpret_cast<uintptr_t>(shard->data) + f.offset;
      uintptr_t aligned = start & ~(pagesz - 1);
      size_t len = f.nbytes + (start - aligned);
      madvise(reinterpret_cast<void*>(aligned), len, MADV_WILLNEED);
    }
  }
}

}  // extern "C"
