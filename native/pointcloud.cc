// Native host-side point-cloud runtime for deepvcp.
//
// The accelerator owns the compute path (JAX/XLA/Pallas); this library owns the
// host-side data runtime the reference delegates to torch DataLoader +
// the knn_cuda extension (SURVEY.md §2.11, §2.14): KITTI velodyne .bin
// parsing, downsampling, and exact-reference-semantics geometry oracles
// (brute-force KNN, FPS, ball query) used for parity testing and CPU
// preprocessing. Exposed with a plain C ABI for ctypes.
//
// Build: see native/build.sh (g++ -O3 -shared -fPIC -fopenmp).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// KITTI velodyne .bin IO (ref KITTIDataset.py:39: float32 x,y,z,reflectance)
// ---------------------------------------------------------------------------

// Returns number of points in the file, or -1 on error.
int64_t velodyne_num_points(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  const long bytes = std::ftell(f);
  std::fclose(f);
  return bytes / (4 * sizeof(float));
}

// Reads up to max_points points into out [max_points, 4].
// Returns points read, or -1 on error.
int64_t velodyne_read(const char* path, float* out, int64_t max_points) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  const size_t got = std::fread(out, 4 * sizeof(float), (size_t)max_points, f);
  std::fclose(f);
  return (int64_t)got;
}

// Read + random downsample (without replacement when possible) to exactly
// n points of xyz into out_xyz [n, 3]. Deterministic in `seed`.
// Returns 0 on success, -1 on IO error.
int velodyne_load_downsample(const char* path, int64_t n, uint64_t seed,
                             float* out_xyz) {
  const int64_t total = velodyne_num_points(path);
  if (total < 0) return -1;
  std::vector<float> buf((size_t)total * 4);
  if (velodyne_read(path, buf.data(), total) != total) return -1;

  std::mt19937_64 rng(seed);
  if (total >= n) {
    // partial Fisher-Yates over indices
    std::vector<int64_t> idx(total);
    for (int64_t i = 0; i < total; ++i) idx[i] = i;
    for (int64_t i = 0; i < n; ++i) {
      std::uniform_int_distribution<int64_t> d(i, total - 1);
      std::swap(idx[i], idx[d(rng)]);
    }
    for (int64_t i = 0; i < n; ++i) {
      const float* p = &buf[(size_t)idx[i] * 4];
      out_xyz[i * 3 + 0] = p[0];
      out_xyz[i * 3 + 1] = p[1];
      out_xyz[i * 3 + 2] = p[2];
    }
  } else {
    // upsample with replacement (static shapes downstream)
    std::uniform_int_distribution<int64_t> d(0, total - 1);
    for (int64_t i = 0; i < n; ++i) {
      const int64_t j = (i < total) ? i : d(rng);
      const float* p = &buf[(size_t)j * 4];
      out_xyz[i * 3 + 0] = p[0];
      out_xyz[i * 3 + 1] = p[1];
      out_xyz[i * 3 + 2] = p[2];
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Geometry oracles (exact reference semantics, for parity tests and host
// preprocessing)
// ---------------------------------------------------------------------------

// Brute-force KNN: for each query, the k nearest refs (ascending).
// ref [n_ref, 3], query [n_query, 3] -> dist [n_query, k], idx [n_query, k].
// Replaces the knn_cuda capability (get_cat_feat_tgt.py:44-52) host-side.
void knn_bruteforce(const float* ref, int64_t n_ref, const float* query,
                    int64_t n_query, int64_t k, float* out_dist,
                    int32_t* out_idx) {
#pragma omp parallel for schedule(static)
  for (int64_t q = 0; q < n_query; ++q) {
    const float qx = query[q * 3], qy = query[q * 3 + 1], qz = query[q * 3 + 2];
    std::vector<std::pair<float, int32_t>> heap;  // max-heap of best k
    heap.reserve((size_t)k + 1);
    for (int64_t r = 0; r < n_ref; ++r) {
      const float dx = ref[r * 3] - qx;
      const float dy = ref[r * 3 + 1] - qy;
      const float dz = ref[r * 3 + 2] - qz;
      const float d2 = dx * dx + dy * dy + dz * dz;
      if ((int64_t)heap.size() < k) {
        heap.emplace_back(d2, (int32_t)r);
        std::push_heap(heap.begin(), heap.end());
      } else if (d2 < heap.front().first) {
        std::pop_heap(heap.begin(), heap.end());
        heap.back() = {d2, (int32_t)r};
        std::push_heap(heap.begin(), heap.end());
      }
    }
    std::sort_heap(heap.begin(), heap.end());
    for (int64_t j = 0; j < k; ++j) {
      out_dist[q * k + j] = std::sqrt(heap[(size_t)j].first);
      out_idx[q * k + j] = heap[(size_t)j].second;
    }
  }
}

// Farthest-point sampling, deterministic from start_idx
// (ref pointnet2_utils.py:63-84 with a fixed start).
void farthest_point_sample(const float* xyz, int64_t n, int64_t npoint,
                           int64_t start_idx, int32_t* out_idx) {
  std::vector<float> dist((size_t)n, 1e30f);
  int64_t far = start_idx;
  for (int64_t i = 0; i < npoint; ++i) {
    out_idx[i] = (int32_t)far;
    const float cx = xyz[far * 3], cy = xyz[far * 3 + 1], cz = xyz[far * 3 + 2];
    float best = -1.0f;
    int64_t best_j = 0;
    for (int64_t j = 0; j < n; ++j) {
      const float dx = xyz[j * 3] - cx;
      const float dy = xyz[j * 3 + 1] - cy;
      const float dz = xyz[j * 3 + 2] - cz;
      const float d = dx * dx + dy * dy + dz * dz;
      if (d < dist[(size_t)j]) dist[(size_t)j] = d;
      if (dist[(size_t)j] > best) {
        best = dist[(size_t)j];
        best_j = j;
      }
    }
    far = best_j;
  }
}

// Ball query, reference semantics (pointnet2_utils.py:87-107): first
// nsample in-radius points by index, padded with the first hit.
// xyz [n, 3], queries [s, 3] -> out_idx [s, nsample].
void query_ball_point(const float* xyz, int64_t n, const float* queries,
                      int64_t s, float radius, int64_t nsample,
                      int32_t* out_idx) {
  const float r2 = radius * radius;
#pragma omp parallel for schedule(static)
  for (int64_t q = 0; q < s; ++q) {
    const float qx = queries[q * 3], qy = queries[q * 3 + 1],
                qz = queries[q * 3 + 2];
    int64_t cnt = 0;
    int32_t first = -1;
    for (int64_t j = 0; j < n && cnt < nsample; ++j) {
      const float dx = xyz[j * 3] - qx;
      const float dy = xyz[j * 3 + 1] - qy;
      const float dz = xyz[j * 3 + 2] - qz;
      if (dx * dx + dy * dy + dz * dz <= r2) {
        if (first < 0) first = (int32_t)j;
        out_idx[q * nsample + cnt++] = (int32_t)j;
      }
    }
    const int32_t pad = first < 0 ? (int32_t)(n - 1) : first;
    for (; cnt < nsample; ++cnt) out_idx[q * nsample + cnt] = pad;
  }
}

// Random-pose pair synthesis (ref ModelNet40Dataset.py:60-92 /
// KITTIDataset.py:65-84): target = R @ src + t with R = Rx Ry Rz of
// uniform angles and t uniform in [-max_t, max_t]^3. R is row-major [9],
// t is [3]; both outputs.
void make_pair(const float* src, int64_t n, uint64_t seed, float max_t,
               float* out_tgt, float* out_R, float* out_t) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> ang(0.0, 2.0 * M_PI);
  std::uniform_real_distribution<double> tr(-max_t, max_t);
  const double ax = ang(rng), ay = ang(rng), az = ang(rng);
  const double cx = std::cos(ax), sx = std::sin(ax);
  const double cy = std::cos(ay), sy = std::sin(ay);
  const double cz = std::cos(az), sz = std::sin(az);
  // R = Rx @ Ry @ Rz (ref utils.py:8-26 composition)
  const double R[9] = {
      cy * cz, -cy * sz, sy,
      sx * sy * cz + cx * sz, -sx * sy * sz + cx * cz, -sx * cy,
      -cx * sy * cz + sx * sz, cx * sy * sz + sx * cz, cx * cy,
  };
  const double t[3] = {tr(rng), tr(rng), tr(rng)};
  for (int i = 0; i < 9; ++i) out_R[i] = (float)R[i];
  for (int i = 0; i < 3; ++i) out_t[i] = (float)t[i];
#pragma omp parallel for schedule(static)
  for (int64_t p = 0; p < n; ++p) {
    const double x = src[p * 3], y = src[p * 3 + 1], z = src[p * 3 + 2];
    out_tgt[p * 3 + 0] = (float)(R[0] * x + R[1] * y + R[2] * z + t[0]);
    out_tgt[p * 3 + 1] = (float)(R[3] * x + R[4] * y + R[5] * z + t[1]);
    out_tgt[p * 3 + 2] = (float)(R[6] * x + R[7] * y + R[8] * z + t[2]);
  }
}

}  // extern "C"
