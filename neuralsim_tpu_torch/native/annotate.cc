// Native annotation kernels: connected components + COCO RLE encoding.
//
// Replacements for the OpenCV/pycocotools C extensions the
// reference depends on (cv2.connectedComponentsWithStats at
// optimization/neural_sim_main.py:787, pycocotools.mask.encode at :825).
// These run host-side in the data path (annotation of rendered images),
// where a C++ union-find beats any vectorized-python formulation.
//
// Build: see neuralsim_tpu_torch/native/build.py (g++ -O2 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct UnionFind {
  std::vector<int32_t> parent;
  explicit UnionFind(size_t n) : parent(n) {
    for (size_t i = 0; i < n; ++i) parent[i] = static_cast<int32_t>(i);
  }
  int32_t find(int32_t x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  }
  void unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a != b) parent[b] = a;
  }
};

}  // namespace

extern "C" {

// Two-pass 8-connected components over a binary HxW mask.
// stats_out: caller-allocated [max_components * 5] int32 (x, y, w, h, area).
// labels_out: optional caller-allocated [H*W] int32 (pass nullptr to skip).
// Returns the number of components written (background excluded), or -1 if
// more than max_components exist.
int32_t connected_components_stats(const uint8_t* mask, int32_t h, int32_t w,
                                   int32_t* stats_out, int32_t max_components,
                                   int32_t* labels_out) {
  const size_t n = static_cast<size_t>(h) * w;
  std::vector<int32_t> labels(n, 0);
  UnionFind uf(n / 2 + 2);
  int32_t next = 1;

  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const size_t i = static_cast<size_t>(y) * w + x;
      if (!mask[i]) continue;
      int32_t up = (y > 0 && mask[i - w]) ? labels[i - w] : 0;
      int32_t left = (x > 0 && mask[i - 1]) ? labels[i - 1] : 0;
      int32_t upleft = (y > 0 && x > 0 && mask[i - w - 1]) ? labels[i - w - 1] : 0;
      int32_t upright =
          (y > 0 && x + 1 < w && mask[i - w + 1]) ? labels[i - w + 1] : 0;
      int32_t lab = 0;
      for (int32_t cand : {up, left, upleft, upright}) {
        if (cand && (!lab || cand < lab)) lab = cand;
      }
      if (!lab) {
        lab = next++;
        if (static_cast<size_t>(lab) >= uf.parent.size())
          uf.parent.push_back(lab);
      } else {
        for (int32_t cand : {up, left, upleft, upright})
          if (cand) uf.unite(lab, cand);
      }
      labels[i] = lab;
    }
  }

  // resolve + compact labels, accumulate stats
  std::vector<int32_t> remap(next, -1);
  std::vector<int32_t> min_x, min_y, max_x, max_y, area;
  int32_t n_comp = 0;
  for (int32_t y = 0; y < h; ++y) {
    for (int32_t x = 0; x < w; ++x) {
      const size_t i = static_cast<size_t>(y) * w + x;
      if (!labels[i]) continue;
      int32_t root = uf.find(labels[i]);
      if (remap[root] < 0) {
        remap[root] = n_comp++;
        min_x.push_back(x);
        min_y.push_back(y);
        max_x.push_back(x);
        max_y.push_back(y);
        area.push_back(0);
      }
      const int32_t c = remap[root];
      if (x < min_x[c]) min_x[c] = x;
      if (y < min_y[c]) min_y[c] = y;
      if (x > max_x[c]) max_x[c] = x;
      if (y > max_y[c]) max_y[c] = y;
      area[c] += 1;
      if (labels_out) labels_out[i] = c + 1;
    }
  }
  if (n_comp > max_components) return -1;
  for (int32_t c = 0; c < n_comp; ++c) {
    stats_out[c * 5 + 0] = min_x[c];
    stats_out[c * 5 + 1] = min_y[c];
    stats_out[c * 5 + 2] = max_x[c] - min_x[c] + 1;
    stats_out[c * 5 + 3] = max_y[c] - min_y[c] + 1;
    stats_out[c * 5 + 4] = area[c];
  }
  return n_comp;
}

// COCO uncompressed RLE: column-major run lengths starting with a 0-run.
// counts_out: caller-allocated [h*w + 1] uint32. Returns run count.
int32_t rle_encode_mask(const uint8_t* mask, int32_t h, int32_t w,
                        uint32_t* counts_out) {
  int32_t n_runs = 0;
  uint8_t current = 0;  // RLE starts counting zeros
  uint32_t run = 0;
  for (int32_t x = 0; x < w; ++x) {
    for (int32_t y = 0; y < h; ++y) {
      uint8_t v = mask[static_cast<size_t>(y) * w + x] ? 1 : 0;
      if (v == current) {
        ++run;
      } else {
        counts_out[n_runs++] = run;
        current = v;
        run = 1;
      }
    }
  }
  counts_out[n_runs++] = run;
  return n_runs;
}

}  // extern "C"
