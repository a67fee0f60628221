/* Greedy non-maximum suppression inner loop — the host-side hot spot of
 * the MTCNN cascade under candidate load (~0.75 ms/call in the numpy
 * implementation at 512 boxes, ~45 calls per 8-frame batch: per-scale
 * 0.5, cross-scale 0.7, stage-2 0.7, stage-3 'min' passes —
 * preprocessing/mtcnn.py:nms_tv / nms).
 *
 * The traversal ORDER is computed by the caller in numpy (argsort tie
 * semantics differ between the two NMS flavors and must stay bit-equal to
 * the reference), so this file only runs the suppression recurrence:
 *
 *   for idx in order:          if alive[idx]: keep it, and
 *     for every later jdx in order still alive:
 *       o = IoU / min-overlap (per `method`), +1 MATLAB areas per
 *       `plus_one`; suppress when o > threshold OR o is NaN
 *       (numpy maps the 0/0 NaN to +inf -> suppressed; IEEE division
 *       here yields the same inf/nan without trapping).
 *
 * Arithmetic runs in the boxes' own dtype (f32 and f64 entry points):
 * the cascade's numbers are float32 tensors and the floor/compare results
 * genuinely differ between f32 and f64 at some boxes, so dtype is part of
 * the contract (see mtcnn.py's stage-1 comment). Elementwise IEEE ops in
 * C match numpy's vectorized ones exactly, so the kept set is bit-equal
 * to the numpy loop (tests/test_native_nms.py fuzzes both).
 *
 * Build: compiled on first import by mintime_tpu/native/__init__.py
 * (gcc -O2 -shared -fPIC, cached next to this file); the numpy path
 * remains as fallback wherever no compiler is available.
 */
#include <math.h>
#include <stdint.h>

#define DEFINE_NMS(SUFFIX, T)                                               \
    long nms_greedy_##SUFFIX(const T *boxes, const int64_t *order, long n,  \
                             T threshold, int method_min, int plus_one,     \
                             int64_t *keep_out) {                           \
        T one = plus_one ? (T)1 : (T)0;                                     \
        long kept = 0;                                                      \
        /* alive flags indexed by order position */                         \
        for (long idx = 0; idx < n; idx++) {                                \
            int64_t i = order[idx];                                         \
            if (i < 0) continue; /* suppressed earlier */                   \
            keep_out[kept++] = i;                                           \
            T x1i = boxes[4 * i], y1i = boxes[4 * i + 1];                   \
            T x2i = boxes[4 * i + 2], y2i = boxes[4 * i + 3];               \
            T area_i = (x2i - x1i + one) * (y2i - y1i + one);               \
            for (long jdx = idx + 1; jdx < n; jdx++) {                      \
                int64_t j = ((int64_t *)order)[jdx];                        \
                if (j < 0) continue;                                        \
                T x1j = boxes[4 * j], y1j = boxes[4 * j + 1];               \
                T x2j = boxes[4 * j + 2], y2j = boxes[4 * j + 3];           \
                T xx1 = x1i > x1j ? x1i : x1j;                              \
                T yy1 = y1i > y1j ? y1i : y1j;                              \
                T xx2 = x2i < x2j ? x2i : x2j;                              \
                T yy2 = y2i < y2j ? y2i : y2j;                              \
                T w = xx2 - xx1 + one;                                      \
                T h = yy2 - yy1 + one;                                      \
                if (w < (T)0) w = (T)0;                                     \
                if (h < (T)0) h = (T)0;                                     \
                T inter = w * h;                                            \
                T area_j = (x2j - x1j + one) * (y2j - y1j + one);           \
                T denom;                                                    \
                if (method_min)                                             \
                    denom = area_i < area_j ? area_i : area_j;              \
                else                                                        \
                    denom = area_i + area_j - inter;                        \
                T o = inter / denom;                                        \
                /* numpy: NaN -> inf -> suppressed; here: !(o<=thr) */      \
                if (!(o <= threshold)) ((int64_t *)order)[jdx] = -1;        \
            }                                                               \
        }                                                                   \
        return kept;                                                        \
    }

DEFINE_NMS(f32, float)
DEFINE_NMS(f64, double)
