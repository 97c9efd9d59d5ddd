// Fast COCO-style detection evaluation (C ABI, loaded via ctypes): the
// port's own copy of the repo's native/cocoeval.cpp, so that the port builds
// from its own sources.
//
// The reference depends on detectron2's COCOeval_opt C++ extension for its
// evaluators (SURVEY §2.2); this is an independent implementation of the
// COCO metric from its definition: greedy per-(image,category) matching at
// IoU .50:.05:.95, 101-point interpolated precision, area ranges with the
// full IGNORE semantics (out-of-range GT absorb detections instead of being
// dropped; unmatched out-of-range detections are ignored), maxDets.
//
// Exposed entry point:
//   coco_evaluate(dets..., gts..., num_classes, max_dets, out)
// with detections/GT as flat arrays sorted by the caller however they like;
// `out` receives per-class AP[ap, ap50, ap75, aps, apm, apl] blocks.
//
// Build: simple_sfod_tpu_torch/host_libs.py (g++ at first use)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

constexpr int kNumThr = 10;
constexpr int kNumRecall = 101;
constexpr int kNumAreas = 4;  // all, small, medium, large

const double kAreaLo[kNumAreas] = {0.0, 0.0, 32.0 * 32.0, 96.0 * 96.0};
const double kAreaHi[kNumAreas] = {1e10, 32.0 * 32.0, 96.0 * 96.0, 1e10};

// np.linspace(0.5, 0.95, 10) BIT-EXACTLY (pycocotools' iouThrs, and the
// numpy fallback's IOU_THRS). Computing 0.5 + 0.05*t here diverges from
// linspace by 1 ULP at t=7,8 — and a detection whose IoU ties the threshold
// exactly then flips match/miss vs the numpy path. Hex literals pin the
// exact doubles regardless of compiler FP contraction.
const double kIouThr[kNumThr] = {
    0x1.0000000000000p-1, 0x1.199999999999ap-1, 0x1.3333333333333p-1,
    0x1.4cccccccccccdp-1, 0x1.6666666666666p-1, 0x1.8000000000000p-1,
    0x1.999999999999ap-1, 0x1.b333333333333p-1, 0x1.cccccccccccccp-1,
    0x1.e666666666666p-1};

struct Box {
  double x1, y1, x2, y2;
  double area() const { return (x2 - x1) * (y2 - y1); }
};

double IoU(const Box& a, const Box& b) {
  const double xx1 = std::max(a.x1, b.x1), yy1 = std::max(a.y1, b.y1);
  const double xx2 = std::min(a.x2, b.x2), yy2 = std::min(a.y2, b.y2);
  const double w = std::max(0.0, xx2 - xx1), h = std::max(0.0, yy2 - yy1);
  const double inter = w * h;
  const double uni = a.area() + b.area() - inter;
  return uni > 0 ? inter / uni : 0.0;
}

struct Det {
  Box box;
  double score;
};

// results of matching one (image, category, area-range): per-threshold flags
struct ImgResult {
  std::vector<double> scores;    // [D]
  std::vector<uint8_t> matched;  // [kNumThr * D]
  std::vector<uint8_t> ignored;  // [kNumThr * D]
  int npig = 0;                  // non-ignored GT count
};

// Per-(class, image) state shared across the 4 area ranges: detections
// sorted/truncated once, IoU matrix (in ORIGINAL gt order) computed once —
// the ranges differ only in gt ignore flags, so recomputing the dominant
// O(d*g) IoU work per range quadrupled the evaluator's cost.
struct ImgPrep {
  std::vector<Det> dets;       // score-sorted, truncated to max_dets
  std::vector<double> iou;     // [d * g] vs gts in original order
};

ImgPrep PrepImage(std::vector<Det> dets, const std::vector<Box>& gts,
                  int max_dets) {
  std::stable_sort(dets.begin(), dets.end(),
                   [](const Det& a, const Det& b) { return a.score > b.score; });
  if ((int)dets.size() > max_dets) dets.resize(max_dets);
  const int d = dets.size(), g = gts.size();
  ImgPrep p;
  p.iou.resize((size_t)d * g);
  for (int i = 0; i < d; ++i)
    for (int j = 0; j < g; ++j) p.iou[(size_t)i * g + j] = IoU(dets[i].box, gts[j]);
  p.dets = std::move(dets);
  return p;
}

ImgResult MatchImage(const ImgPrep& prep, const std::vector<Box>& gts_in,
                     double lo, double hi) {
  const std::vector<Det>& dets = prep.dets;
  const int d = dets.size();

  // ignore flags; non-ignored GT first (stable), like COCOeval's gtind sort
  std::vector<int> perm;       // position in the ORIGINAL gt order
  std::vector<uint8_t> gig;
  perm.reserve(gts_in.size());
  for (int j = 0; j < (int)gts_in.size(); ++j)
    if (gts_in[j].area() >= lo && gts_in[j].area() < hi) {
      perm.push_back(j);
      gig.push_back(0);
    }
  int npig = perm.size();
  for (int j = 0; j < (int)gts_in.size(); ++j)
    if (!(gts_in[j].area() >= lo && gts_in[j].area() < hi)) {
      perm.push_back(j);
      gig.push_back(1);
    }
  const int g = perm.size();
  const int g0 = gts_in.size();

  ImgResult r;
  r.npig = npig;
  r.scores.resize(d);
  r.matched.assign(kNumThr * d, 0);
  r.ignored.assign(kNumThr * d, 0);
  for (int i = 0; i < d; ++i) r.scores[i] = dets[i].score;
  if (d && g) {
    for (int t = 0; t < kNumThr; ++t) {
      const double thr = kIouThr[t];
      std::vector<uint8_t> taken(g, 0);
      for (int i = 0; i < d; ++i) {
        int best = -1;
        // pycocotools-exact: threshold min(thr, 1-1e-10); accept at
        // iou >= running best, so equal-IoU ties take the LATER gt
        double best_iou = std::min(thr, 1.0 - 1e-10);
        for (int j = 0; j < g; ++j) {
          if (taken[j]) continue;
          // holding a non-ignored match and reaching ignored GT: stop
          if (best >= 0 && !gig[best] && gig[j]) break;
          if (prep.iou[(size_t)i * g0 + perm[j]] >= best_iou) {
            best = j;
            best_iou = prep.iou[(size_t)i * g0 + perm[j]];
          }
        }
        if (best >= 0) {
          taken[best] = 1;
          r.matched[t * d + i] = 1;
          r.ignored[t * d + i] = gig[best];
        }
      }
    }
  }
  // unmatched detections outside the area range are ignored
  for (int i = 0; i < d; ++i) {
    const double a = dets[i].box.area();
    if (a >= lo && a < hi) continue;
    for (int t = 0; t < kNumThr; ++t)
      if (!r.matched[t * d + i]) r.ignored[t * d + i] = 1;
  }
  return r;
}

// Accumulate one (category, area) curve over images -> AP per threshold.
void ApCurve(const std::vector<ImgResult>& imgs, double* ap_out /*[kNumThr]*/,
             double* ar_out /*nullable, recall@maxDets averaged over thr*/) {
  int64_t npig = 0, total_d = 0;
  for (const auto& r : imgs) {
    npig += r.npig;
    total_d += r.scores.size();
  }
  for (int t = 0; t < kNumThr; ++t) ap_out[t] = -1.0;  // sentinel: no GT
  if (ar_out) *ar_out = -1.0;
  if (npig == 0) return;
  if (total_d == 0) {
    for (int t = 0; t < kNumThr; ++t) ap_out[t] = 0.0;
    if (ar_out) *ar_out = 0.0;
    return;
  }

  // merge detections across images, sort by score desc
  std::vector<std::pair<double, std::pair<int, int>>> order;  // score, (img, i)
  order.reserve(total_d);
  for (int im = 0; im < (int)imgs.size(); ++im)
    for (int i = 0; i < (int)imgs[im].scores.size(); ++i)
      order.push_back({imgs[im].scores[i], {im, i}});
  std::stable_sort(order.begin(), order.end(),
                   [](const auto& a, const auto& b) { return a.first > b.first; });

  double recall_sum = 0.0;
  for (int t = 0; t < kNumThr; ++t) {
    std::vector<double> prec, rec;
    prec.reserve(total_d);
    rec.reserve(total_d);
    int64_t tp = 0, fp = 0;
    for (int64_t k = 0; k < total_d; ++k) {
      const auto& e = order[k].second;
      const auto& img = imgs[e.first];
      const int d = img.scores.size();
      if (img.ignored[t * d + e.second]) continue;  // ignored: neither TP nor FP
      if (img.matched[t * d + e.second])
        ++tp;
      else
        ++fp;
      prec.push_back(double(tp) / double(tp + fp));
      rec.push_back(double(tp) / double(npig));
    }
    // envelope
    for (int64_t k = (int64_t)prec.size() - 2; k >= 0; --k)
      prec[k] = std::max(prec[k], prec[k + 1]);
    // 101-point interpolation
    double ap = 0.0;
    for (int ri = 0; ri < kNumRecall; ++ri) {
      // np.linspace(0, 1, 101) computes i * 0.01 (verified bit-equal in
      // Python); ri / 100.0 differs by 1 ULP at 10 indices, which includes/
      // excludes recall values that tie a threshold exactly (e.g. 7/20)
      const double r = ri * 0.01;
      // first index with rec >= r
      auto it = std::lower_bound(rec.begin(), rec.end(), r);
      if (it != rec.end()) ap += prec[it - rec.begin()];
    }
    ap_out[t] = ap / kNumRecall;
    recall_sum += rec.empty() ? 0.0 : rec.back();
  }
  if (ar_out) *ar_out = recall_sum / kNumThr;
}

}  // namespace

extern "C" {

// detections: n_det entries of (image_id, category, score, x1, y1, x2, y2)
// gts:        n_gt entries of (image_id, category, x1, y1, x2, y2)
// image_ids:  the FULL evaluation image set (n_img entries) — images with no
//             GT still contribute their detections as false positives
// categories contiguous [0, num_classes)
// out: per class, kNumAreas blocks of (kNumThr APs) then 1 AR  ->
//      out[c * (kNumAreas*kNumThr + 1) + a*kNumThr + t]; AR at block end.
// returns 0 on success.
int coco_evaluate(const int64_t* det_img, const int32_t* det_cat,
                  const double* det_score, const double* det_box, int64_t n_det,
                  const int64_t* gt_img, const int32_t* gt_cat,
                  const double* gt_box, int64_t n_gt, const int64_t* image_ids,
                  int32_t n_img_in, int32_t num_classes, int32_t max_dets,
                  double* out) {
  std::unordered_map<int64_t, int> img_index;
  for (int32_t i = 0; i < n_img_in; ++i) img_index.emplace(image_ids[i], i);
  const int n_img = n_img_in;

  std::vector<std::vector<std::vector<Det>>> dets(
      num_classes, std::vector<std::vector<Det>>(n_img));
  std::vector<std::vector<std::vector<Box>>> gts(
      num_classes, std::vector<std::vector<Box>>(n_img));
  for (int64_t i = 0; i < n_det; ++i) {
    auto it = img_index.find(det_img[i]);
    if (it == img_index.end()) continue;
    const int c = det_cat[i];
    if (c < 0 || c >= num_classes) continue;
    dets[c][it->second].push_back(
        {{det_box[i * 4], det_box[i * 4 + 1], det_box[i * 4 + 2],
          det_box[i * 4 + 3]},
         det_score[i]});
  }
  for (int64_t i = 0; i < n_gt; ++i) {
    const int c = gt_cat[i];
    if (c < 0 || c >= num_classes) continue;
    auto it = img_index.find(gt_img[i]);
    if (it == img_index.end()) continue;
    gts[c][it->second].push_back({gt_box[i * 4], gt_box[i * 4 + 1],
                                  gt_box[i * 4 + 2], gt_box[i * 4 + 3]});
  }

  const int block = kNumAreas * kNumThr + 1;
  for (int c = 0; c < num_classes; ++c) {
    std::vector<ImgPrep> preps;
    preps.reserve(n_img);
    for (int im = 0; im < n_img; ++im)
      preps.push_back(PrepImage(dets[c][im], gts[c][im], max_dets));
    for (int a = 0; a < kNumAreas; ++a) {
      std::vector<ImgResult> results;
      results.reserve(n_img);
      for (int im = 0; im < n_img; ++im)
        results.push_back(
            MatchImage(preps[im], gts[c][im], kAreaLo[a], kAreaHi[a]));
      double ar = -1.0;
      ApCurve(results, out + c * block + a * kNumThr, a == 0 ? &ar : nullptr);
      if (a == 0) out[c * block + kNumAreas * kNumThr] = ar;
    }
  }
  return 0;
}

// Layout handshake: the Python binding sizes/reshapes the flat `out` buffer
// with its own copies of these constants — it calls this at load time and
// refuses the library if they disagree (a silent mismatch would misparse
// APs into wrong slots).
void coco_layout(int32_t* num_thr, int32_t* num_areas) {
  *num_thr = kNumThr;
  *num_areas = kNumAreas;
}
}
