/* COCO-compatible RLE mask codec + RLE-space IoU, implemented from the
 * format specification (column-major run lengths starting with a zero-run;
 * compressed string form = delta-coded counts in 5-bit groups with a
 * continuation bit, offset by 48).
 *
 * The codec is a copy of nuhtc_tpu/native/rle.c: host code in plain C, no
 * CUDA. It stands where the reference depends on pycocotools' C maskApi; a
 * fresh implementation, with no code taken from pycocotools. Added for the
 * slide's per-tile post-processing, on masks held whole: one pass for each
 * mask's area and pixel box, the pixels two masks share over the overlap of
 * their boxes, and a mask's RLE from its crop.
 *
 * Build (done at first use by nuhtc_tpu_torch/kernels host(), with contours.c):
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

/* ---- masks held whole: (n, h, w) uint8, row-major ---------------------- */
/* the high bit of each non-zero byte of v (no carry crosses a byte) */
static inline uint64_t nonzero_high_bits(uint64_t v) {
  const uint64_t low7 = 0x7f7f7f7f7f7f7f7full;
  return (((v & low7) + low7) | v) & ~low7;
}

/* One pass over n masks: each mask's area (its non-zero pixels) and its
 * pixel box [y0, y1, x0, x1) (ends exclusive; all 0 for an empty mask). */
void mask_extents(const uint8_t *masks, int64_t n, int64_t h, int64_t w,
                  int64_t *area, int64_t *box) {
  for (int64_t k = 0; k < n; k++) {
    const uint8_t *m = masks + k * h * w;
    int64_t a = 0, y0 = -1, y1 = 0, x0 = w, x1 = 0;
    for (int64_t y = 0; y < h; y++) {
      const uint8_t *row = m + y * w;
      int64_t x = 0, first = -1, last = -1;
      for (; x + 8 <= w; x += 8) {
        uint64_t word;
        memcpy(&word, row + x, 8);
        if (!word) continue;
        a += __builtin_popcountll(nonzero_high_bits(word));
        for (int64_t j = 0; j < 8; j++) {
          if (row[x + j]) {
            if (first < 0) first = x + j;
            last = x + j;
          }
        }
      }
      for (; x < w; x++) {
        if (row[x]) {
          a++;
          if (first < 0) first = x;
          last = x;
        }
      }
      if (first < 0) continue;
      if (y0 < 0) y0 = y;
      y1 = y + 1;
      if (first < x0) x0 = first;
      if (last + 1 > x1) x1 = last + 1;
    }
    int64_t *b = box + 4 * k;
    area[k] = a;
    if (y0 < 0) {
      b[0] = b[1] = b[2] = b[3] = 0;
    } else {
      b[0] = y0; b[1] = y1; b[2] = x0; b[3] = x1;
    }
  }
}

/* Pixels that masks first[i] and second[i] share, counted over the overlap
 * of their boxes (as mask_extents gives them; a mask has no pixel outside
 * its box), for each of the k pairs. */
void mask_pair_inter(const uint8_t *masks, int64_t h, int64_t w, const int64_t *box,
                     const int64_t *first, const int64_t *second, int64_t k,
                     int64_t *inter) {
  for (int64_t i = 0; i < k; i++) {
    const int64_t *ba = box + 4 * first[i], *bb = box + 4 * second[i];
    const uint8_t *ma = masks + first[i] * h * w, *mb = masks + second[i] * h * w;
    int64_t y0 = ba[0] > bb[0] ? ba[0] : bb[0], y1 = ba[1] < bb[1] ? ba[1] : bb[1];
    int64_t x0 = ba[2] > bb[2] ? ba[2] : bb[2], x1 = ba[3] < bb[3] ? ba[3] : bb[3];
    int64_t c = 0;
    for (int64_t y = y0; y < y1; y++)
      for (int64_t x = x0; x < x1; x++) c += ma[y * w + x] && mb[y * w + x];
    inter[i] = c;
  }
}

/* The counts rle_encode gives for an h x w mask that is zero outside a
 * ch x cw crop at rows y0.., columns x0.. of it; the crop is row-major with
 * rows `stride` bytes apart. Returns the number of counts, or -1 if cap
 * (2 * ch * cw + 1 is always enough) is exceeded. */
int64_t rle_encode_crop(const uint8_t *crop, int64_t stride, int64_t ch, int64_t cw,
                        int64_t y0, int64_t x0, int64_t h, int64_t w,
                        uint32_t *counts_out, int64_t cap) {
  int64_t m = 0, done = 0, start = -1, end = -1; /* done: end of the last run written */
  for (int64_t x = 0; x < cw; x++) {
    for (int64_t y = 0; y < ch; y++) {
      if (!crop[y * stride + x]) continue;
      int64_t p = (x0 + x) * h + y0 + y; /* the pixel's column-major index */
      if (p == end) {
        end++;
        continue;
      }
      if (start >= 0) {
        if (m + 2 > cap) return -1;
        counts_out[m++] = (uint32_t)(start - done);
        counts_out[m++] = (uint32_t)(end - start);
        done = end;
      }
      start = p;
      end = p + 1;
    }
  }
  if (start >= 0) {
    if (m + 2 > cap) return -1;
    counts_out[m++] = (uint32_t)(start - done);
    counts_out[m++] = (uint32_t)(end - start);
    done = end;
  }
  if (done < h * w || m == 0) {
    if (m >= cap) return -1;
    counts_out[m++] = (uint32_t)(h * w - done);
  }
  return m;
}
