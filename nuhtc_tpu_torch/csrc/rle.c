/* COCO-compatible RLE mask codec + RLE-space IoU, implemented from the
 * format specification (column-major run lengths starting with a zero-run;
 * compressed string form = delta-coded counts in 5-bit groups with a
 * continuation bit, offset by 48).
 *
 * A copy of nuhtc_tpu/native/rle.c: host code in plain C, no CUDA. It stands
 * where the reference depends on pycocotools' C maskApi; a fresh
 * implementation, with no code taken from pycocotools.
 *
 * Build (done at first use by nuhtc_tpu_torch/ops/rle.py, with contours.c):
 *   cc -O2 -shared -fPIC rle.c contours.c -o libhost.so
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ---- run-length extraction ------------------------------------------- */
/* mask: h*w uint8 in COLUMN-major (Fortran) order.
 * counts_out: caller-allocated buffer of capacity cap (uint32).
 * returns number of counts written, or -1 if cap exceeded. */
int64_t rle_encode(const uint8_t *mask, int64_t h, int64_t w,
                   uint32_t *counts_out, int64_t cap) {
  int64_t n = h * w, m = 0, i = 0;
  uint8_t cur = 0; /* runs alternate starting with zeros */
  int64_t run = 0;
  for (i = 0; i < n; i++) {
    uint8_t v = mask[i] ? 1 : 0;
    if (v == cur) {
      run++;
    } else {
      if (m >= cap) return -1;
      counts_out[m++] = (uint32_t)run;
      cur = v;
      run = 1;
    }
  }
  if (m >= cap) return -1;
  counts_out[m++] = (uint32_t)run;
  return m;
}

/* decode counts into column-major uint8 mask (caller allocates h*w). */
void rle_decode(const uint32_t *counts, int64_t m, uint8_t *mask, int64_t n) {
  int64_t pos = 0;
  uint8_t v = 0;
  for (int64_t i = 0; i < m && pos < n; i++) {
    int64_t run = counts[i];
    if (run > n - pos) run = n - pos;
    memset(mask + pos, v, (size_t)run);
    pos += run;
    v = !v;
  }
}

uint64_t rle_area(const uint32_t *counts, int64_t m) {
  uint64_t a = 0;
  for (int64_t i = 1; i < m; i += 2) a += counts[i];
  return a;
}

/* tight bbox [x1, y1, w, h] from counts (column-major over h-tall columns) */
void rle_bbox(const uint32_t *counts, int64_t m, int64_t h, double *bb) {
  int64_t xs = INT64_MAX, xe = -1, ys = INT64_MAX, ye = -1;
  int64_t pos = 0;
  uint8_t v = 0;
  for (int64_t i = 0; i < m; i++) {
    int64_t run = counts[i];
    if (v) {
      int64_t start = pos, end = pos + run - 1;
      int64_t cs = start / h, ce = end / h;
      if (cs < xs) xs = cs;
      if (ce > xe) xe = ce;
      if (cs == ce) {
        int64_t rs = start % h, re = end % h;
        if (rs < ys) ys = rs;
        if (re > ye) ye = re;
      } else {
        ys = 0;
        if (h - 1 > ye) ye = h - 1;
      }
    }
    pos += run;
    v = !v;
  }
  if (xe < 0) { bb[0] = bb[1] = bb[2] = bb[3] = 0; return; }
  bb[0] = (double)xs;
  bb[1] = (double)ys;
  bb[2] = (double)(xe - xs + 1);
  bb[3] = (double)(ye - ys + 1);
}

/* intersection area of two RLEs via two-pointer sweep over runs */
uint64_t rle_intersection(const uint32_t *a, int64_t ma,
                          const uint32_t *b, int64_t mb) {
  uint64_t inter = 0;
  int64_t ia = 0, ib = 0;
  uint64_t ea = a[0], eb = b[0]; /* end position of current run (exclusive) */
  uint64_t pos = 0;
  uint8_t va = 0, vb = 0;
  while (ia < ma && ib < mb) {
    uint64_t next = ea < eb ? ea : eb;
    if (va && vb) inter += next - pos;
    pos = next;
    if (ea == next) { ia++; va = !va; if (ia < ma) ea += a[ia]; }
    if (eb == next) { ib++; vb = !vb; if (ib < mb) eb += b[ib]; }
  }
  return inter;
}

/* pairwise IoU between n_d and n_g RLEs; arrays are flattened counts with
 * per-item offsets/lengths. iscrowd: per-gt flag -> IoF semantics. */
void rle_iou(const uint32_t *dt_counts, const int64_t *dt_off, const int64_t *dt_len,
             int64_t nd,
             const uint32_t *gt_counts, const int64_t *gt_off, const int64_t *gt_len,
             int64_t ng, const uint8_t *iscrowd, double *out) {
  for (int64_t i = 0; i < nd; i++) {
    uint64_t da = rle_area(dt_counts + dt_off[i], dt_len[i]);
    for (int64_t j = 0; j < ng; j++) {
      uint64_t ga = rle_area(gt_counts + gt_off[j], gt_len[j]);
      uint64_t it = rle_intersection(dt_counts + dt_off[i], dt_len[i],
                                     gt_counts + gt_off[j], gt_len[j]);
      double u = iscrowd && iscrowd[j] ? (double)da
                                       : (double)(da + ga - it);
      out[i * ng + j] = u > 0 ? (double)it / u : 0.0;
    }
  }
}

/* ---- LEB128-style string coding (COCO "counts" string) ----------------- */
/* encode counts -> char string; returns length or -1 if cap exceeded. */
int64_t rle_string_encode(const uint32_t *counts, int64_t m, char *out, int64_t cap) {
  int64_t p = 0;
  for (int64_t i = 0; i < m; i++) {
    int64_t x = (int64_t)counts[i];
    if (i > 2) x -= (int64_t)counts[i - 2];
    int more = 1;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      /* sign-aware continuation: continue while remaining bits matter */
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      c += 48;
      if (p >= cap) return -1;
      out[p++] = (char)c;
    }
  }
  return p;
}

/* decode char string -> counts; returns number of counts or -1. */
int64_t rle_string_decode(const char *s, int64_t slen, uint32_t *counts, int64_t cap) {
  int64_t m = 0, p = 0;
  while (p < slen) {
    int64_t x = 0, k = 0;
    int more = 1;
    while (more) {
      if (p >= slen) return -1;
      int64_t c = (int64_t)s[p++] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = c & 0x20;
      if (!more && (c & 0x10)) x |= -1L << (5 * (k + 1)); /* sign extend */
      k++;
    }
    if (m > 2) x += (int64_t)counts[m - 2];
    if (m >= cap) return -1;
    counts[m++] = (uint32_t)x;
  }
  return m;
}
