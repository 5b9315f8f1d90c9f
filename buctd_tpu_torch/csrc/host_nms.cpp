// Host box NMS: the port's own copy of native/nms.cpp.
//
// Counterpart of the reference's compiled NMS (lib/nms/cpu_nms.pyx:20-71 and
// the CUDA bitmask kernel lib/nms/nms_kernel.cu:33-143).  Two entry points:
//   * buctd_cpu_nms   - greedy NMS over score-sorted boxes, exact cpu_nms
//                       semantics (+1 pixel-area convention, suppress on
//                       ovr >= thresh)
//   * buctd_mask_nms  - the 64-wide bitmask form of the same greedy scan (the
//                       CUDA kernel's algorithm, blocked for the CPU's
//                       caches; suppress on ovr > thresh like the CUDA path)
//
// Built with the host C++ compiler at first use and bound with ctypes
// (buctd_tpu_torch/_build.py::build_host, buctd_tpu_torch/ops/native.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct Box {
  float x1, y1, x2, y2, score;
};

inline float iou_plus1(const Box& a, const Box& b) {
  const float xx1 = std::max(a.x1, b.x1);
  const float yy1 = std::max(a.y1, b.y1);
  const float xx2 = std::min(a.x2, b.x2);
  const float yy2 = std::min(a.y2, b.y2);
  const float w = std::max(0.0f, xx2 - xx1 + 1.0f);
  const float h = std::max(0.0f, yy2 - yy1 + 1.0f);
  const float inter = w * h;
  const float area_a = (a.x2 - a.x1 + 1.0f) * (a.y2 - a.y1 + 1.0f);
  const float area_b = (b.x2 - b.x1 + 1.0f) * (b.y2 - b.y1 + 1.0f);
  return inter / (area_a + area_b - inter);
}

std::vector<int> score_order(const Box* boxes, int n) {
  std::vector<int> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
    return boxes[a].score > boxes[b].score;
  });
  return order;
}

}  // namespace

extern "C" {

// dets: (n, 5) row-major [x1, y1, x2, y2, score]; keep: out buffer of size n.
// Returns the number of kept indices (original, unsorted indices — matching
// cpu_nms.pyx which returns indices into the input array in score order).
int buctd_cpu_nms(const float* dets, int n, float thresh, int* keep) {
  const Box* boxes = reinterpret_cast<const Box*>(dets);
  const std::vector<int> order = score_order(boxes, n);
  std::vector<char> suppressed(n, 0);

  int num_keep = 0;
  for (int oi = 0; oi < n; ++oi) {
    const int i = order[oi];
    if (suppressed[i]) continue;
    keep[num_keep++] = i;
    for (int oj = oi + 1; oj < n; ++oj) {
      const int j = order[oj];
      if (suppressed[j]) continue;
      if (iou_plus1(boxes[i], boxes[j]) >= thresh) suppressed[j] = 1;
    }
  }
  return num_keep;
}

// Bitmask greedy NMS, the nms_kernel.cu algorithm on CPU: phase 1 builds 64-bit
// suppression masks block-by-block (cache-friendly, vectorizable); phase 2 is the
// host-side greedy scan over mask bits (gpu_nms.pyx:16-34 / nms_kernel.cu:104-131).
// Input must already be sorted by descending score (as gpu_nms sorts first);
// suppression on ovr > thresh.
int buctd_mask_nms(const float* dets_sorted, int n, float thresh, int* keep) {
  constexpr int kBlock = 64;
  const Box* boxes = reinterpret_cast<const Box*>(dets_sorted);
  const int col_blocks = (n + kBlock - 1) / kBlock;
  std::vector<uint64_t> mask(static_cast<size_t>(n) * col_blocks, 0);

  for (int rb = 0; rb < col_blocks; ++rb) {
    for (int cb = rb; cb < col_blocks; ++cb) {
      const int row_size = std::min(n - rb * kBlock, kBlock);
      const int col_size = std::min(n - cb * kBlock, kBlock);
      for (int r = 0; r < row_size; ++r) {
        const int row = rb * kBlock + r;
        uint64_t t = 0;
        const int start = (rb == cb) ? r + 1 : 0;
        for (int c = start; c < col_size; ++c) {
          if (iou_plus1(boxes[row], boxes[cb * kBlock + c]) > thresh) {
            t |= 1ULL << c;
          }
        }
        mask[static_cast<size_t>(row) * col_blocks + cb] = t;
      }
    }
  }

  std::vector<uint64_t> remv(col_blocks, 0);
  int num_keep = 0;
  for (int i = 0; i < n; ++i) {
    const int nblock = i / kBlock;
    const int inblock = i % kBlock;
    if (!(remv[nblock] & (1ULL << inblock))) {
      keep[num_keep++] = i;
      const uint64_t* p = &mask[static_cast<size_t>(i) * col_blocks];
      for (int j = nblock; j < col_blocks; ++j) remv[j] |= p[j];
    }
  }
  return num_keep;
}

}  // extern "C"
