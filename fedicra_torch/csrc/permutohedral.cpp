// The port's copy of fedicra_tpu/native/permutohedral.cpp, built by
// fedicra_torch/ops/_build.py with the same g++ flags.
//
// Permutohedral-lattice Gaussian filtering (Adams, Baek, Davis 2010).
//
// Approximates y_i = sum_j exp(-||p_i - p_j||^2 / 2) v_j in O(N d^2) by
// splatting values onto the permutohedral lattice of the hyperplane
// H_d = {x in R^{d+1} : sum x = 0}, separably blurring with a [1 2 1]
// stencil along each of the d+1 lattice directions, then slicing back.
//
// The reference vendors the same capability as a SWIG extension
// (code/utils/pytorch/wrapper/bilateralfilter/permutohedral.cpp, dead in its
// live path, used only by utils/DenseCRFLoss.py). This is an independent
// implementation: flat open-addressing hash table, C ABI, batch entry point
// with one thread per batch element (matching the execution model the
// reference uses for its host kernels, e.g. mst.cu:93-114).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Open-addressing hash table mapping short[kd] lattice keys -> dense slot.
struct KeyTable {
  int kd;            // key length (= d: last coord is implied by zero-sum)
  size_t capacity;   // power of two
  std::vector<int16_t> keys;   // capacity * kd
  std::vector<int32_t> slots;  // capacity, -1 = empty
  int32_t n_entries = 0;

  KeyTable(int kd_, size_t expected) : kd(kd_) {
    capacity = 16;
    while (capacity < expected * 2) capacity <<= 1;
    keys.assign(capacity * kd, 0);
    slots.assign(capacity, -1);
  }

  static uint64_t hash(const int16_t* k, int kd) {
    uint64_t h = 14695981039346656037ull;
    for (int i = 0; i < kd; i++) {
      h ^= static_cast<uint64_t>(static_cast<uint16_t>(k[i]));
      h *= 1099511628211ull;
    }
    return h;
  }

  // Insert-or-find; returns the dense slot index.
  int32_t intern(const int16_t* k) {
    size_t mask = capacity - 1;
    size_t idx = hash(k, kd) & mask;
    for (;;) {
      int32_t s = slots[idx];
      if (s == -1) {
        std::memcpy(&keys[idx * kd], k, kd * sizeof(int16_t));
        slots[idx] = n_entries;
        return n_entries++;
      }
      if (std::memcmp(&keys[idx * kd], k, kd * sizeof(int16_t)) == 0) return s;
      idx = (idx + 1) & mask;
    }
  }

  // Find-only; returns -1 when absent.
  int32_t find(const int16_t* k) const {
    size_t mask = capacity - 1;
    size_t idx = hash(k, kd) & mask;
    for (;;) {
      int32_t s = slots[idx];
      if (s == -1) return -1;
      if (std::memcmp(&keys[idx * kd], k, kd * sizeof(int16_t)) == 0) return s;
      idx = (idx + 1) & mask;
    }
  }
};

void filter_one(const float* positions, const float* values, float* out,
                int N, int d, int c) {
  const int dp1 = d + 1;

  // Elevation scale factors: undo the variance distortion of the E-matrix
  // embedding so a unit Gaussian in position space maps to the lattice blur.
  std::vector<float> scale(d);
  const float inv_std_dev = std::sqrt(2.0f / 3.0f) * dp1;
  for (int i = 0; i < d; i++)
    scale[i] = inv_std_dev / std::sqrt(static_cast<float>((i + 1) * (i + 2)));

  KeyTable table(d, static_cast<size_t>(N) * dp1);
  // Per-input simplex membership: dp1 (slot, barycentric-weight) pairs.
  std::vector<int32_t> splat_slot(static_cast<size_t>(N) * dp1);
  std::vector<float> splat_w(static_cast<size_t>(N) * dp1);

  std::vector<float> elevated(dp1);
  std::vector<int> greedy(dp1), rank(dp1);
  std::vector<float> bary(d + 2);
  std::vector<int16_t> key(d);

  for (int n = 0; n < N; n++) {
    const float* p = positions + static_cast<size_t>(n) * d;

    // Embed into H_d: elevated = E * (p .* scale), computed by the
    // telescoping recurrence (sum of elevated coords is exactly 0).
    float sm = 0.0f;
    for (int i = d; i > 0; i--) {
      float cf = p[i - 1] * scale[i - 1];
      elevated[i] = sm - i * cf;
      sm += cf;
    }
    elevated[0] = sm;

    // Nearest remainder-0 lattice point: round to multiples of d+1, then
    // repair the rounding so the point stays on the hyperplane.
    int sum = 0;
    for (int i = 0; i <= d; i++) {
      int rd = static_cast<int>(std::lround(elevated[i] / dp1));
      greedy[i] = rd * dp1;
      sum += rd;
    }
    for (int i = 0; i <= d; i++) {
      rank[i] = 0;
      for (int j = 0; j <= d; j++) {
        float di = elevated[i] - greedy[i], dj = elevated[j] - greedy[j];
        if (di < dj || (di == dj && i > j)) rank[i]++;
      }
    }
    if (sum > 0) {
      for (int i = 0; i <= d; i++) {
        if (rank[i] >= dp1 - sum) {
          greedy[i] -= dp1;
          rank[i] += sum - dp1;
        } else {
          rank[i] += sum;
        }
      }
    } else if (sum < 0) {
      for (int i = 0; i <= d; i++) {
        if (rank[i] < -sum) {
          greedy[i] += dp1;
          rank[i] += dp1 + sum;
        } else {
          rank[i] += sum;
        }
      }
    }

    // Barycentric coordinates inside the enclosing simplex.
    std::fill(bary.begin(), bary.end(), 0.0f);
    for (int i = 0; i <= d; i++) {
      float delta = (elevated[i] - greedy[i]) / dp1;
      bary[d - rank[i]] += delta;
      bary[d + 1 - rank[i]] -= delta;
    }
    bary[0] += 1.0f + bary[d + 1];

    // The dp1 simplex vertices: remainder-r point has coordinate
    // greedy[i] + r shifted down by d+1 wherever rank[i] >= d+1-r.
    for (int r = 0; r <= d; r++) {
      for (int i = 0; i < d; i++)
        key[i] = static_cast<int16_t>(
            greedy[i] + r - (rank[i] >= dp1 - r ? dp1 : 0));
      splat_slot[static_cast<size_t>(n) * dp1 + r] = table.intern(key.data());
      splat_w[static_cast<size_t>(n) * dp1 + r] = bary[r];
    }
  }

  const int M = table.n_entries;
  // Dense copy of the interned keys, ordered by slot, for the blur pass.
  std::vector<int16_t> slot_keys(static_cast<size_t>(M) * d);
  for (size_t idx = 0; idx < table.capacity; idx++) {
    int32_t s = table.slots[idx];
    if (s >= 0)
      std::memcpy(&slot_keys[static_cast<size_t>(s) * d],
                  &table.keys[idx * d], d * sizeof(int16_t));
  }

  // Splat.
  std::vector<float> lat(static_cast<size_t>(M) * c, 0.0f);
  for (int n = 0; n < N; n++) {
    const float* v = values + static_cast<size_t>(n) * c;
    for (int r = 0; r <= d; r++) {
      int32_t s = splat_slot[static_cast<size_t>(n) * dp1 + r];
      float w = splat_w[static_cast<size_t>(n) * dp1 + r];
      float* dst = &lat[static_cast<size_t>(s) * c];
      for (int ch = 0; ch < c; ch++) dst[ch] += w * v[ch];
    }
  }

  // Blur with [1 2 1]/2 along each lattice direction. Neighbors along
  // direction j differ by +1 in every key coordinate except -d in the j-th
  // (and the implied last coordinate when j == d).
  std::vector<float> lat2(static_cast<size_t>(M) * c);
  std::vector<int16_t> nkey(d);
  for (int j = 0; j <= d; j++) {
    for (int s = 0; s < M; s++) {
      const int16_t* k = &slot_keys[static_cast<size_t>(s) * d];
      for (int i = 0; i < d; i++) nkey[i] = static_cast<int16_t>(k[i] + 1);
      if (j < d) nkey[j] = static_cast<int16_t>(k[j] - d);
      int32_t up = table.find(nkey.data());
      for (int i = 0; i < d; i++) nkey[i] = static_cast<int16_t>(k[i] - 1);
      if (j < d) nkey[j] = static_cast<int16_t>(k[j] + d);
      int32_t dn = table.find(nkey.data());

      const float* self = &lat[static_cast<size_t>(s) * c];
      const float* pu = up >= 0 ? &lat[static_cast<size_t>(up) * c] : nullptr;
      const float* pd = dn >= 0 ? &lat[static_cast<size_t>(dn) * c] : nullptr;
      float* dst = &lat2[static_cast<size_t>(s) * c];
      for (int ch = 0; ch < c; ch++) {
        float nb = (pu ? pu[ch] : 0.0f) + (pd ? pd[ch] : 0.0f);
        dst[ch] = self[ch] + 0.5f * nb;
      }
    }
    lat.swap(lat2);
  }

  // Slice. alpha undoes the mass the d+1 blur passes multiplied in.
  const float alpha = 1.0f / (1.0f + std::pow(2.0f, -d));
  for (int n = 0; n < N; n++) {
    float* o = out + static_cast<size_t>(n) * c;
    for (int ch = 0; ch < c; ch++) o[ch] = 0.0f;
    for (int r = 0; r <= d; r++) {
      int32_t s = splat_slot[static_cast<size_t>(n) * dp1 + r];
      float w = splat_w[static_cast<size_t>(n) * dp1 + r] * alpha;
      const float* src = &lat[static_cast<size_t>(s) * c];
      for (int ch = 0; ch < c; ch++) o[ch] += w * src[ch];
    }
  }
}

}  // namespace

extern "C" {

// positions [B,N,d] (pre-divided by sigma), values [B,N,c] -> out [B,N,c].
void permutohedral_filter_batch(const float* positions, const float* values,
                                float* out, int B, int N, int d, int c) {
  std::vector<std::thread> workers;
  workers.reserve(B);
  for (int b = 0; b < B; b++) {
    workers.emplace_back([=]() {
      filter_one(positions + static_cast<size_t>(b) * N * d,
                 values + static_cast<size_t>(b) * N * c,
                 out + static_cast<size_t>(b) * N * c, N, d, c);
    });
  }
  for (auto& t : workers) t.join();
}

}  // extern "C"
