// fastgraph: native host-side data kernels for ragraph_tpu.
//
// The reference's data layer is pure-Python hot loops: tab-separated
// edge-file parsing line by line (RAGraph_edge/utils/dataloader.py:47-70)
// and per-edge rejection-sampled negatives in a Python while loop
// (dataloader.py:142-152). At production scale (tens of millions of
// interactions) those dominate host time. These C++ kernels feed the TPU
// input pipeline instead; Python binds them via ctypes (no pybind11 in
// the image).
//
// Exposed C ABI:
//   fg_count_edges(path)                        -> number of (u, i, t) rows
//   fg_parse_edge_file(path, users, items, times, cap) -> rows written
//   fg_negative_sample(users, n, hist_keys, n_hist, n_items, seed, n_negs,
//                      out)                     -> 0 on success
//   fg_build_csr(src, n_edges, n_nodes, indptr, indices_out)
//   fg_degree_count(idx, n, out, n_nodes)

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

// ---------------------------------------------------------------------------
// Edge-file parsing: "user \t i1 i2 i3 \t t1 t2 t3\n"
// ---------------------------------------------------------------------------

static bool read_file(const char* path, std::vector<char>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf.resize(static_cast<size_t>(size) + 1);
  size_t got = fread(buf.data(), 1, static_cast<size_t>(size), f);
  fclose(f);
  buf[got] = '\0';
  return true;
}

static inline const char* skip_spaces(const char* p) {
  while (*p == ' ' || *p == '\r') ++p;  // '\r': tolerate CRLF files
  return p;
}

static inline int64_t parse_int(const char*& p) {
  int64_t v = 0;
  bool neg = false;
  if (*p == '-') { neg = true; ++p; }
  while (*p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
  return neg ? -v : v;
}

// Parse one line "user \t items \t times"; returns rows appended.
template <typename Emit>
static void parse_buffer(const char* p, Emit emit) {
  while (*p) {
    // user
    p = skip_spaces(p);
    if (*p == '\n') { ++p; continue; }
    if (!*p) break;
    int64_t user = parse_int(p);
    while (*p == '\t' || *p == ' ') ++p;
    // items until tab or newline
    std::vector<int64_t> items;
    while (*p && *p != '\t' && *p != '\n') {
      p = skip_spaces(p);
      if (*p == '\t' || *p == '\n' || !*p) break;
      if ((*p >= '0' && *p <= '9') || *p == '-') {
        items.push_back(parse_int(p));
      } else {
        ++p;  // stray non-numeric byte: skip — parse_int would not
              // advance and the loop would spin forever
      }
      while (*p == ' ') ++p;
    }
    // times (optional)
    std::vector<int64_t> times;
    if (*p == '\t') {
      ++p;
      while (*p && *p != '\n') {
        p = skip_spaces(p);
        if (*p == '\n' || !*p) break;
        if ((*p >= '0' && *p <= '9') || *p == '-') {
          times.push_back(parse_int(p));
        } else {
          ++p;  // see above
        }
        while (*p == ' ') ++p;
      }
    }
    for (size_t k = 0; k < items.size(); ++k) {
      int64_t t = k < times.size() ? times[k] : 0;
      emit(user, items[k], t);
    }
    if (*p == '\n') ++p;
  }
}

extern "C" int64_t fg_count_edges(const char* path) {
  std::vector<char> buf;
  if (!read_file(path, buf)) return -1;
  int64_t count = 0;
  parse_buffer(buf.data(),
               [&](int64_t, int64_t, int64_t) { ++count; });
  return count;
}

extern "C" int64_t fg_parse_edge_file(const char* path, int32_t* users, int32_t* items,
                           int64_t* times, int64_t capacity) {
  std::vector<char> buf;
  if (!read_file(path, buf)) return -1;
  int64_t n = 0;
  parse_buffer(buf.data(), [&](int64_t u, int64_t i, int64_t t) {
    if (n < capacity) {
      users[n] = static_cast<int32_t>(u);
      items[n] = static_cast<int32_t>(i);
      times[n] = t;
    }
    ++n;
  });
  return n;
}

// ---------------------------------------------------------------------------
// Rejection-sampled negatives against a sorted history-key table
// ---------------------------------------------------------------------------

static inline uint64_t splitmix64(uint64_t& s) {
  uint64_t z = (s += 0x9E3779B97f4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

static inline bool key_in(const int64_t* keys, int64_t n, int64_t key) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (keys[mid] < key) lo = mid + 1; else hi = mid;
  }
  return lo < n && keys[lo] == key;
}

extern "C" int32_t fg_negative_sample(const int32_t* users, int64_t n_users,
                           const int64_t* hist_keys, int64_t n_hist,
                           int64_t n_items, uint64_t seed, int32_t n_negs,
                           int32_t* out) {
  uint64_t state = seed ^ 0xD1B54A32D192ED03ULL;
  for (int64_t b = 0; b < n_users; ++b) {
    int64_t u = users[b];
    for (int32_t j = 0; j < n_negs; ++j) {
      int64_t item;
      int tries = 0;
      do {
        item = static_cast<int64_t>(splitmix64(state) % (uint64_t)n_items);
        ++tries;
      } while (tries < 1000 &&
               key_in(hist_keys, n_hist, u * n_items + item));
      out[b * n_negs + j] = static_cast<int32_t>(item);
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// CSR assembly (counting sort by source node)
// ---------------------------------------------------------------------------

extern "C" int32_t fg_build_csr(const int32_t* src, const int32_t* dst, int64_t n_edges,
                     int64_t n_nodes, int64_t* indptr, int32_t* indices) {
  std::vector<int64_t> counts(static_cast<size_t>(n_nodes) + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) counts[src[e] + 1]++;
  for (int64_t v = 0; v < n_nodes; ++v) counts[v + 1] += counts[v];
  std::memcpy(indptr, counts.data(), sizeof(int64_t) * (n_nodes + 1));
  std::vector<int64_t> cursor(counts.begin(), counts.end() - 1);
  for (int64_t e = 0; e < n_edges; ++e) {
    indices[cursor[src[e]]++] = dst[e];
  }
  return 0;
}

extern "C" int32_t fg_degree_count(const int32_t* idx, int64_t n, int64_t* out,
                        int64_t n_nodes) {
  std::memset(out, 0, sizeof(int64_t) * n_nodes);
  for (int64_t e = 0; e < n; ++e) {
    if (idx[e] >= 0 && idx[e] < n_nodes) out[idx[e]]++;
  }
  return 0;
}

