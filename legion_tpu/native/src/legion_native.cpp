// legion_native: C++ host runtime for legion_tpu.
//
// Equivalents of the reference's host-side machinery:
//   - gather_rows_f32: multithreaded feature-row gather from host memory —
//     the role of Legion's zero-copy UVA feature reads over PCIe
//     (multiGPU_feat_cache_lookup host branch, cache_impl.cuh:239-272),
//     batched per step instead of per-thread-element.
//   - sample_neighbors: uniform-with-replacement neighbor draws from a host
//     CSR for topology-cache misses — the role of the UVA fallback reads in
//     random_sample (operator_impl.cu:224-243).
//   - edge_list_to_csr / CSR file IO: the offline converter
//     (dataset/gen_legion_xtrapulp_fomat.cpp) rebuilt with the same output
//     contract (int64 indptr "edge_src", int32 indices "edge_dst",
//     self-loops dropped).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in this image).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <functional>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

void parallel_for(int64_t n, int n_threads,
                  const std::function<void(int64_t, int64_t)>& body) {
  if (n_threads <= 1 || n < (1 << 14)) {
    body(0, n);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    ts.emplace_back([=, &body] { body(lo, hi); });
  }
  for (auto& t : ts) t.join();
}

// splitmix64: cheap stateless per-slot RNG (deterministic given seed+slot,
// the reference used thrust::minstd_rand.discard(idx) the same way,
// operator_impl.cu:235-238)
inline uint64_t splitmix64(uint64_t x) {
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

}  // namespace

extern "C" {

// Gather rows: out[i] = src[ids[i]] for ids[i] >= 0 else zeros.
void lg_gather_rows_f32(const float* src, int64_t n_rows, int64_t row_len,
                        const int32_t* ids, int64_t n_ids, float* out,
                        int n_threads) {
  parallel_for(n_ids, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int32_t id = ids[i];
      float* dst = out + i * row_len;
      if (id >= 0 && id < n_rows) {
        std::memcpy(dst, src + (int64_t)id * row_len,
                    row_len * sizeof(float));
      } else {
        std::memset(dst, 0, row_len * sizeof(float));
      }
    }
  });
}

// Gather rows converting f32 -> bf16 in flight (round-to-nearest-even).
// Halves the host->device bytes of the host-feature miss paths.
void lg_gather_rows_bf16(const float* src, int64_t n_rows, int64_t row_len,
                         const int32_t* ids, int64_t n_ids, uint16_t* out,
                         int n_threads) {
  parallel_for(n_ids, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int32_t id = ids[i];
      uint16_t* dst = out + i * row_len;
      if (id >= 0 && id < n_rows) {
        const float* row = src + (int64_t)id * row_len;
        for (int64_t j = 0; j < row_len; ++j) {
          uint32_t bits;
          std::memcpy(&bits, row + j, 4);
          // round-to-nearest-even bf16
          uint32_t rounded = bits + 0x7fffu + ((bits >> 16) & 1u);
          dst[j] = (uint16_t)(rounded >> 16);
        }
      } else {
        std::memset(dst, 0, row_len * sizeof(uint16_t));
      }
    }
  });
}

// Uniform-with-replacement neighbor sampling from a host CSR.
// frontier ids < 0 or degree-0 rows emit -1s.
void lg_sample_neighbors(const int64_t* indptr, const int32_t* indices,
                         int64_t n_nodes, const int32_t* frontier,
                         int64_t n_frontier, int fanout, uint64_t seed,
                         int32_t* out, int n_threads) {
  parallel_for(n_frontier, n_threads, [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      int32_t v = frontier[i];
      int32_t* dst = out + i * fanout;
      if (v < 0 || v >= n_nodes) {
        for (int f = 0; f < fanout; ++f) dst[f] = -1;
        continue;
      }
      int64_t lo_e = indptr[v], hi_e = indptr[v + 1];
      int64_t deg = hi_e - lo_e;
      if (deg <= 0) {
        for (int f = 0; f < fanout; ++f) dst[f] = -1;
        continue;
      }
      for (int f = 0; f < fanout; ++f) {
        uint64_t r = splitmix64(seed ^ ((uint64_t)i * fanout + f));
        dst[f] = indices[lo_e + (int64_t)(r % (uint64_t)deg)];
      }
    }
  });
}

// Build CSR from an edge list (host arrays). Drops self loops
// (gen_legion_xtrapulp_fomat.cpp:90). Returns number of kept edges.
// indptr must have n_nodes+1 slots; indices_out at least n_edges slots.
int64_t lg_edges_to_csr(const int64_t* src, const int64_t* dst,
                        int64_t n_edges, int64_t n_nodes, int64_t* indptr,
                        int32_t* indices_out) {
  std::memset(indptr, 0, (n_nodes + 1) * sizeof(int64_t));
  for (int64_t e = 0; e < n_edges; ++e) {
    if (src[e] == dst[e]) continue;
    if (src[e] < 0 || src[e] >= n_nodes || dst[e] < 0 || dst[e] >= n_nodes)
      continue;
    indptr[src[e] + 1]++;
  }
  for (int64_t v = 0; v < n_nodes; ++v) indptr[v + 1] += indptr[v];
  std::vector<int64_t> cursor(indptr, indptr + n_nodes);
  int64_t kept = indptr[n_nodes];
  for (int64_t e = 0; e < n_edges; ++e) {
    if (src[e] == dst[e]) continue;
    if (src[e] < 0 || src[e] >= n_nodes || dst[e] < 0 || dst[e] >= n_nodes)
      continue;
    indices_out[cursor[src[e]]++] = (int32_t)dst[e];
  }
  return kept;
}

// Convert a whitespace-separated text edge list file to Legion binaries
// (edge_src int64 indptr, edge_dst int32 indices), compacting vertex ids in
// first-appearance order like the reference converter
// (gen_legion_xtrapulp_fomat.cpp:120-141). Returns 0 on success.
int lg_convert_edgelist(const char* in_path, const char* out_dir,
                        int64_t* out_nodes, int64_t* out_edges);

// mmap helpers for tests / loaders
int64_t lg_file_size(const char* path) {
  struct stat st;
  if (stat(path, &st) != 0) return -1;
  return st.st_size;
}

// Streaming Linear Deterministic Greedy (LDG) partitioner. Plays the role
// of the reference's offline XtraPuLP min-cut partitioning
// (graph_partitioning.py:104-138) without the MPI dependency: each vertex
// goes to the partition holding most of its already-placed neighbors,
// damped by a capacity penalty. `passes` > 1 refines assignments.
void lg_partition_ldg(const int64_t* indptr, const int32_t* indices,
                      int64_t n_nodes, int32_t n_parts, int32_t passes,
                      int32_t* part) {
  std::vector<int64_t> size(n_parts, 0);
  for (int64_t v = 0; v < n_nodes; ++v) part[v] = -1;
  double cap = (double)n_nodes / n_parts * 1.05 + 1.0;
  std::vector<int64_t> cnt(n_parts);
  for (int32_t pass = 0; pass < passes; ++pass) {
    for (int64_t v = 0; v < n_nodes; ++v) {
      std::fill(cnt.begin(), cnt.end(), 0);
      for (int64_t e = indptr[v]; e < indptr[v + 1]; ++e) {
        int32_t p = part[indices[e]];
        if (p >= 0) cnt[p]++;
      }
      int32_t old = part[v];
      if (old >= 0) size[old]--;
      double best_score = -1e300;
      int32_t best = 0;
      for (int32_t p = 0; p < n_parts; ++p) {
        double score =
            (double)cnt[p] * (1.0 - (double)size[p] / cap);
        if (score > best_score ||
            (score == best_score && size[p] < size[best])) {
          best_score = score;
          best = p;
        }
      }
      part[v] = best;
      size[best]++;
    }
  }
}

}  // extern "C"

extern "C" int lg_convert_edgelist(const char* in_path, const char* out_dir,
                                   int64_t* out_nodes, int64_t* out_edges) {
  int fd = open(in_path, O_RDONLY);
  if (fd < 0) return 1;
  struct stat st;
  fstat(fd, &st);
  const char* buf =
      (const char*)mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  if (buf == MAP_FAILED) {
    close(fd);
    return 2;
  }
  std::vector<int64_t> src, dst;
  std::unordered_map<int64_t, int64_t> compact;
  const char* p = buf;
  const char* end = buf + st.st_size;
  auto intern = [&](int64_t raw) {
    auto it = compact.find(raw);
    if (it != compact.end()) return it->second;
    int64_t id = (int64_t)compact.size();
    compact.emplace(raw, id);
    return id;
  };
  while (p < end) {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
    if (p >= end) break;
    int64_t a = 0, b = 0;
    bool neg = (*p == '-');
    if (neg) ++p;
    while (p < end && *p >= '0' && *p <= '9') a = a * 10 + (*p++ - '0');
    if (neg) a = -a;
    while (p < end && (*p == ' ' || *p == '\t')) ++p;
    neg = (p < end && *p == '-');
    if (neg) ++p;
    while (p < end && *p >= '0' && *p <= '9') b = b * 10 + (*p++ - '0');
    if (neg) b = -b;
    if (a == b) continue;  // self loop
    src.push_back(intern(a));
    dst.push_back(intern(b));
  }
  munmap((void*)buf, st.st_size);
  close(fd);

  int64_t n_nodes = (int64_t)compact.size();
  int64_t n_edges = (int64_t)src.size();
  std::vector<int64_t> indptr(n_nodes + 1);
  std::vector<int32_t> indices(n_edges);
  int64_t kept = lg_edges_to_csr(src.data(), dst.data(), n_edges, n_nodes,
                                 indptr.data(), indices.data());
  std::string dir(out_dir);
  FILE* f = fopen((dir + "/edge_src").c_str(), "wb");
  if (!f) return 3;
  fwrite(indptr.data(), sizeof(int64_t), n_nodes + 1, f);
  fclose(f);
  f = fopen((dir + "/edge_dst").c_str(), "wb");
  if (!f) return 3;
  fwrite(indices.data(), sizeof(int32_t), kept, f);
  fclose(f);
  *out_nodes = n_nodes;
  *out_edges = kept;
  return 0;
}
