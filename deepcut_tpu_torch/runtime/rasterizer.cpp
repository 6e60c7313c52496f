// Native target rasterizer: the prefetch-thread hot path in C++.
//
// Computes the deterministic core of the PoseData target construction
// (scores / locref / pairwise maps; semantics identical to
// deepcut_tpu/pose/targets.py::rasterize, which mirrors the reference's
// pose_data_layer.cpp:676-804). Negative sampling stays in Python so the
// RNG stream matches the reference exactly.
//
// Build: python -m deepcut_tpu_torch.runtime.build   (g++ -O3 -shared -fPIC)
// ABI: plain C, loaded via ctypes (deepcut_tpu_torch/runtime/__init__.py).
//
// Layout: all maps are HWC row-major float32, matching the numpy arrays.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {
constexpr float kIgnore = 1000.0f;
constexpr float kFgScoreThresh = 0.05f;
constexpr int kStride = 8;
constexpr int kHalfStride = 4;
const float kLocrefStd = std::sqrt(53.0f);
constexpr float kFloatMax = std::numeric_limits<float>::max();
}  // namespace

extern "C" {

// Returns the number of positive (foreground) cells.
int dc_rasterize(
    // flattened (person, joint) entries, reference iteration order
    const int32_t* entry_cls, const float* entry_xy, const int32_t* entry_person,
    int n_entries,
    const int64_t* joint_index,  // (num_people, J) global entry idx or -1
    int num_people, int J, int skip_class,
    // grid geometry
    int th, int tw, int sh, int sw,
    float scale, float fg_threshold, int soft_labels, float sigma,
    int multi_label, int no_bg_class, int use_fg_fraction,
    int locref, int allreg,
    // pairwise edge table
    const int32_t* edges, const float* means, const float* stds, int E,
    // outputs (pre-initialised by caller: labels=ignore, others zero/one)
    float* labels,        // (sh, sw, C) with C = J + (no_bg ? 0 : 1)
    float* loc_t, float* loc_w,      // (sh, sw, 2J)
    float* next_t, float* next_w,    // (sh, sw, 2E)
    uint8_t* sample_mask,            // (sh, sw)
    float* min_distance)             // (sh, sw)
{
  const int C = J + (no_bg_class ? 0 : 1);
  const int first = no_bg_class ? 1 : 0;
  const int n_scores = skip_class + 1;
  std::vector<float> scores(n_scores);
  std::vector<float> dists(J);
  std::vector<int> class_arg(J);
  std::vector<int> person_of(J);
  int num_positives = 0;

  for (int j = 0; j < th; ++j) {
    for (int i = 0; i < tw; ++i) {
      const float ptx = (i * kStride + kHalfStride) / scale;
      const float pty = (j * kStride + kHalfStride) / scale;

      std::fill(scores.begin(), scores.end(), 0.0f);
      std::fill(dists.begin(), dists.end(), kFloatMax);
      std::fill(class_arg.begin(), class_arg.end(), -1);
      std::fill(person_of.begin(), person_of.end(), -1);
      float min_dist = kFloatMax;
      int closest_joint = -1;
      bool skip_sample = false;
      float skip_score = 0.0f;

      for (int e = 0; e < n_entries; ++e) {
        const int cls = entry_cls[e];
        const float dx = entry_xy[2 * e] - ptx;
        const float dy = entry_xy[2 * e + 1] - pty;
        const float dist = std::sqrt(dx * dx + dy * dy);
        const float sc = soft_labels
                             ? std::exp(-dist * dist / (2 * sigma * sigma))
                             : (dist <= fg_threshold ? 1.0f : 0.0f);
        if (cls != skip_class) {
          const int jid = cls - 1;
          if (dist < dists[jid]) {
            dists[jid] = dist;
            scores[cls] = sc;
            class_arg[jid] = e;
            person_of[jid] = entry_person[e];
          }
        } else {
          if (sc > scores[skip_class]) scores[skip_class] = sc;
          if (scores[skip_class] > kFgScoreThresh) skip_sample = true;
        }
        if (dist < min_dist) {
          min_dist = dist;
          closest_joint = cls;
        }
      }

      const long cell = (long)j * sw + i;
      min_distance[cell] = min_dist;
      scores[0] = closest_joint >= 0 ? 1.0f - scores[closest_joint] : 1.0f;

      const bool is_fg = soft_labels ? (scores[0] <= 1.0f - kFgScoreThresh)
                                     : (min_dist <= fg_threshold);
      if (is_fg) ++num_positives;
      if (is_fg || skip_sample) sample_mask[cell] = 1;
      if (skip_sample) continue;
      if (use_fg_fraction && !is_fg) continue;

      if (!soft_labels && !multi_label) {
        const int curr = is_fg ? closest_joint : 0;
        for (int c = 0; c < n_scores; ++c) scores[c] = (c == curr) ? 1.0f : 0.0f;
      }
      float* lab = labels + cell * C;
      for (int c = first; c <= J; ++c) lab[c - first] = scores[c];

      if (is_fg && locref) {
        for (int c = 1; c <= J; ++c) {
          if (scores[c] < kFgScoreThresh) continue;
          const int jid = c - 1;
          const int e = class_arg[jid];
          if (e < 0) continue;
          const float dx = (entry_xy[2 * e] - ptx) * scale;
          const float dy = (entry_xy[2 * e + 1] - pty) * scale;
          float* lt = loc_t + cell * 2 * J + 2 * jid;
          float* lw = loc_w + cell * 2 * J + 2 * jid;
          lt[0] = dx / kLocrefStd;
          lt[1] = dy / kLocrefStd;
          lw[0] = 1.0f;
          lw[1] = 1.0f;
        }
      }
      if (is_fg && allreg) {
        for (int l = 0; l < E; ++l) {
          const int cls = edges[2 * l];
          const int next_cls = edges[2 * l + 1];
          if (scores[cls] < kFgScoreThresh) continue;
          const int pidx = person_of[cls - 1];
          if (pidx < 0) continue;
          const int64_t ne = joint_index[(int64_t)pidx * J + (next_cls - 1)];
          if (ne < 0) continue;
          const float ddx = (entry_xy[2 * ne] - ptx) * scale;
          const float ddy = (entry_xy[2 * ne + 1] - pty) * scale;
          float* nt = next_t + cell * 2 * E + 2 * l;
          float* nw = next_w + cell * 2 * E + 2 * l;
          nt[0] = (ddx - means[2 * l]) / stds[2 * l];
          nt[1] = (ddy - means[2 * l + 1]) / stds[2 * l + 1];
          nw[0] = 1.0f;
          nw[1] = 1.0f;
        }
      }
    }
  }
  return num_positives;
}

}  // extern "C"
