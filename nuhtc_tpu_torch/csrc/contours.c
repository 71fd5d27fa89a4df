/* Border following after Suzuki and Abe (1985) with OpenCV's conventions:
 * the border tracer of nuhtc_tpu_torch/ops/contours.py (find_contours_plain)
 * in C, step for step, so that both give the same borders point for point.
 *
 * The mask is cropped to the bounding box of its non-zero pixels and padded
 * by a zero frame (border 1). Rows are scanned in raster order for a change
 * 0 -> 1 (an outer border starts at the 1) or 1 -> 0 (a hole border starts
 * at the 1 left of the 0); each new border takes its parent from the border
 * met last on its row to the left (lnbd) and is traced at once, its pixels
 * marked +nbd, or -nbd where the search passed east and found background.
 *
 * The contours then come out in pre-order of the border tree, siblings newest
 * first, with OpenCV's hierarchy rows.
 *
 * Host code in plain C, no CUDA. Built with rle.c into one library at first
 * use by nuhtc_tpu_torch/ops/rle.py:
 *   cc -O2 -shared -fPIC rle.c contours.c -o libhost.so
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* chain codes 0..7: east, north-east, north, ... counter-clockwise on the screen */
static const int64_t DX[8] = {1, 1, 0, -1, -1, -1, 0, 1};
static const int64_t DY[8] = {0, -1, -1, -1, 0, 1, 1, 1};

/* the high bit of each non-zero byte of v (no carry crosses a byte) */
static inline uint64_t nonzero_bytes(uint64_t v) {
  const uint64_t low7 = 0x7f7f7f7f7f7f7f7full;
  return (((v & low7) + low7) | v) & ~low7;
}

/* the first non-zero byte of r[from .. to), or -1 */
static int64_t first_set(const uint8_t *r, int64_t from, int64_t to) {
  int64_t x = from;
  for (; x + 8 <= to; x += 8) {
    uint64_t v;
    memcpy(&v, r + x, 8);
    if (v) break;
  }
  for (; x < to; x++)
    if (r[x]) return x;
  return -1;
}

/* the last non-zero byte of r[from .. to), or -1 */
static int64_t last_set(const uint8_t *r, int64_t from, int64_t to) {
  int64_t x = to;
  for (; x - 8 >= from; x -= 8) {
    uint64_t v;
    memcpy(&v, r + x - 8, 8);
    if (v) break;
  }
  for (; x > from; x--)
    if (r[x - 1]) return x - 1;
  return -1;
}

/* whether r[0 .. w) has a non-zero byte */
static int any_set(const uint8_t *r, int64_t w) {
  uint64_t acc0 = 0, acc1 = 0;
  int64_t x = 0;
  for (; x + 16 <= w; x += 16) {
    uint64_t v0, v1;
    memcpy(&v0, r + x, 8);
    memcpy(&v1, r + x + 8, 8);
    acc0 |= v0;
    acc1 |= v1;
  }
  for (; x < w; x++) acc0 |= r[x];
  return (acc0 | acc1) != 0;
}

/* A growing array of int32. */
typedef struct {
  int32_t *p;
  int64_t n, cap;
} vec;

static int push(vec *v, int32_t a) {
  if (v->n == v->cap) {
    int64_t cap = v->cap ? 2 * v->cap : 256;
    int32_t *p = (int32_t *)realloc(v->p, (size_t)cap * sizeof(int32_t));
    if (!p) return -1;
    v->p = p;
    v->cap = cap;
  }
  v->p[v->n++] = a;
  return 0;
}

/* The padded crop of the mask while its borders are followed: st holds 0
 * for background, 1 for foreground not yet on a border, 2 for a pixel a
 * border passed (the tracer's +nbd) and 3 for one a border passed with
 * background examined on its east side (-nbd); lab holds that border's
 * number, read only where st is 2 or 3. */
typedef struct {
  uint8_t *st;
  int32_t *lab;
  int64_t stride;
} image;

/* Follows one border of im from (y0, x0), marks it as border nbd and appends
 * its (x, y) points, shifted by (sx, sy), to pts; returns the number of
 * points, or -1 when memory ran out. */
static int64_t trace(image *im, int64_t y0, int64_t x0, int is_hole, int32_t nbd, int simple,
                     int64_t sx, int64_t sy, vec *pts) {
  uint8_t *st = im->st;
  int32_t *lab = im->lab;
  int64_t off[8];
  for (int k = 0; k < 8; k++) off[k] = DY[k] * im->stride + DX[k];
  const int64_t p0 = y0 * im->stride + x0;
  int s, s_end;
  s_end = s = is_hole ? 0 : 4;
  for (;;) {
    s = (s - 1) & 7;
    if (st[p0 + off[s]] != 0 || s == s_end) break;
  }
  if (st[p0 + off[s]] == 0) { /* a single pixel */
    st[p0] = 3;
    lab[p0] = nbd;
    if (push(pts, (int32_t)(x0 + sx)) || push(pts, (int32_t)(y0 + sy))) return -1;
    return 1;
  }
  const int64_t p1 = p0 + off[s];
  int64_t p3 = p0, y3 = y0, x3 = x0, count = 0;
  int prev_s = s ^ 4;
  for (;;) {
    int64_t p4;
    s_end = s;
    do { /* the next foreground neighbour, counter-clockwise */
      s++;
      p4 = p3 + off[s & 7];
    } while (st[p4] == 0);
    s &= 7;
    /* the search passed east (code 8) and found background there */
    if (1 <= s && s <= s_end) {
      st[p3] = 3;
      lab[p3] = nbd;
    } else if (st[p3] == 1) {
      st[p3] = 2;
      lab[p3] = nbd;
    }
    if (s != prev_s || !simple) {
      if (push(pts, (int32_t)(x3 + sx)) || push(pts, (int32_t)(y3 + sy))) return -1;
      count++;
      prev_s = s;
    }
    if (p4 == p0 && p3 == p1) break;
    p3 = p4;
    y3 += DY[s];
    x3 += DX[s];
    s = (s + 4) & 7;
  }
  return count;
}

/* The borders of an h x w mask (row-major, non-zero = foreground) in the
 * order they are found: border b (2, 3, ...; 1 is the frame) has parent
 * parent[b], points [start[b], start[b] + npts[b]) of pts. Returns the
 * last border's number (1 for an empty mask), or -1 when memory ran out. */
static int64_t follow(const uint8_t *mask, int64_t h, int64_t w, int ccomp, int simple,
                      vec *parent, vec *hole, vec *start, vec *npts, vec *pts) {
  int64_t oy = -1, ey = -1, ox = w, ex = -1;
  for (int64_t y = 0; y < h; y++) {
    const uint8_t *r = mask + y * w;
    if (!any_set(r, w)) continue;
    if (oy < 0) oy = y;
    ey = y;
    int64_t a = first_set(r, 0, ox), b = last_set(r, ex + 1, w);
    if (a >= 0) ox = a;
    if (b >= 0) ex = b;
  }
  /* border 0 is unused, border 1 the frame: a hole around everything */
  for (int k = 0; k < 2; k++)
    if (push(parent, 0) || push(hole, k) || push(start, 0) || push(npts, 0)) return -1;
  if (oy < 0) return 1;

  /* the bounding box with a zero frame: nothing outside it can start or
   * bend a border, and raster order inside it is that of the whole image */
  const int64_t ch = ey - oy + 3, cw = ex - ox + 3;
  image im = {(uint8_t *)malloc((size_t)(ch * cw)),
              (int32_t *)malloc((size_t)(ch * cw) * sizeof(int32_t)), cw};
  if (!im.st || !im.lab) {
    free(im.st);
    free(im.lab);
    return -1;
  }
  memset(im.st, 0, (size_t)cw);
  memset(im.st + (ch - 1) * cw, 0, (size_t)cw);
  for (int64_t y = 1; y < ch - 1; y++) {
    const uint8_t *r = mask + (oy + y - 1) * w + ox;
    uint8_t *row = im.st + y * cw + 1;
    int64_t x = 0;
    row[-1] = row[cw - 2] = 0;
    for (; x + 8 <= cw - 2; x += 8) { /* 1 for each non-zero byte */
      uint64_t v;
      memcpy(&v, r + x, 8);
      v = nonzero_bytes(v) >> 7;
      memcpy(row + x, &v, 8);
    }
    for (; x < cw - 2; x++) row[x] = r[x] != 0;
  }
  int32_t nbd = 1;
  int64_t rc = 0;
  const int64_t sx = ox - 1, sy = oy - 1;
  for (int64_t y = 1; y < ch - 1 && rc == 0; y++) {
    const uint8_t *row = im.st + y * cw;
    const int32_t *lab = im.lab + y * cw;
    for (int64_t i = 0; i + 1 < cw; i++) {
      /* background stays 0 and foreground non-zero while borders are
       * marked, so these are the changes of the mask itself: found eight
       * at a time, where a byte's zero-ness differs from its right neighbour's */
      if (i + 9 <= cw) {
        uint64_t a, b;
        memcpy(&a, row + i, 8);
        memcpy(&b, row + i + 1, 8);
        const uint64_t changes = nonzero_bytes(a) ^ nonzero_bytes(b);
        if (!changes) {
          i += 7;
          continue;
        }
        i += __builtin_ctzll(changes) >> 3;
      }
      int64_t x, from;
      int is_hole;
      if (row[i] == 0 && row[i + 1] != 0) {
        x = i + 1;
        if (row[x] != 1) continue;
        is_hole = 0;
        from = x - 1;
      } else if (row[i] != 0 && row[i + 1] == 0) {
        x = i;
        if (row[x] == 3) continue;
        is_hole = 1;
        from = x;
      } else {
        continue;
      }
      /* the border met last on this row: the last marked pixel left of the start */
      int32_t lnbd = 1;
      for (int64_t xx = from; xx > 0; xx--)
        if (row[xx] >= 2) {
          lnbd = lab[xx];
          break;
        }
      nbd++;
      int32_t par;
      if (!is_hole && ccomp)
        par = 1;
      else
        par = hole->p[lnbd] == is_hole ? parent->p[lnbd] : lnbd;
      int64_t at = pts->n / 2;
      int64_t n = trace(&im, y, x, is_hole, nbd, simple, sx, sy, pts);
      if (n < 0 || push(parent, par) || push(hole, is_hole) || push(start, (int32_t)at) ||
          push(npts, (int32_t)n)) {
        rc = -1;
        break;
      }
    }
  }
  free(im.st);
  free(im.lab);
  return rc < 0 ? -1 : nbd;
}

/* cv2.findContours(mask, mode, method) for the h x w mask (row-major,
 * non-zero = foreground): mode 0 RETR_EXTERNAL, 2 RETR_CCOMP, 3 RETR_TREE;
 * simple: CHAIN_APPROX_SIMPLE (a point where the chain code changes), else
 * CHAIN_APPROX_NONE (every point). Contours in pre-order of the border tree,
 * siblings newest first (RETR_EXTERNAL: the tree's top level in that order).
 *
 * out (cap >= 2 int32) receives, for n contours of p points in all: n, p;
 * the n hierarchy rows of (next, previous, first child, parent) indices, -1
 * for none; the n + 1 offsets of the contours in the points, 0 first and p
 * last; the p (x, y) points, the contours one after the other.
 *
 * Returns 0; 1 when the rest did not fit (out holds n and p: call again with
 * 2 + 5 n + 1 + 2 p); -1 when memory ran out. */
int64_t contours_find(const uint8_t *mask, int64_t h, int64_t w, int32_t mode, int32_t simple,
                      int32_t *out, int64_t cap) {
  vec parent = {0}, hole = {0}, start = {0}, npts = {0}, pts = {0};
  vec first = {0}, next = {0}, prev = {0}, index = {0}, order = {0};
  int64_t rc = -1;
  out[0] = out[1] = 0;
  int64_t nbd = follow(mask, h, w, mode == 2, simple, &parent, &hole, &start, &npts, &pts);
  if (nbd < 0) goto done;
  /* children newest first: first[p] the last border found in p, next[b]
   * the one found before b in the same parent */
  for (int64_t b = 0; b <= nbd; b++)
    if (push(&first, 0) || push(&next, 0) || push(&prev, 0) || push(&index, -1)) goto done;
  for (int64_t b = 2; b <= nbd; b++) {
    int32_t p = parent.p[b];
    next.p[b] = first.p[p];
    if (first.p[p]) prev.p[first.p[p]] = (int32_t)b;
    first.p[p] = (int32_t)b;
  }
  /* pre-order of the tree under the frame; RETR_EXTERNAL stays on its top level */
  int64_t np = 0;
  for (int32_t b = first.p[1]; b;) {
    index.p[b] = (int32_t)order.n;
    if (push(&order, b)) goto done;
    np += npts.p[b];
    if (first.p[b] && mode != 0) {
      b = first.p[b];
      continue;
    }
    while (b != 1 && !next.p[b]) b = parent.p[b];
    if (b == 1) break;
    b = next.p[b];
  }
  const int64_t nc = order.n;
  out[0] = (int32_t)nc;
  out[1] = (int32_t)np;
  if (2 + 5 * nc + 1 + 2 * np > cap) {
    rc = 1;
    goto done;
  }
  int32_t *hierarchy = out + 2, *offsets = hierarchy + 4 * nc, *points = offsets + nc + 1;
  int64_t at = 0;
  offsets[0] = 0;
  for (int64_t i = 0; i < nc; i++) {
    int32_t b = order.p[i], *row = hierarchy + 4 * i;
    if (mode == 0) {
      row[0] = i + 1 < nc ? (int32_t)i + 1 : -1;
      row[1] = (int32_t)i - 1;
      row[2] = row[3] = -1;
    } else {
      row[0] = next.p[b] ? index.p[next.p[b]] : -1;
      row[1] = prev.p[b] ? index.p[prev.p[b]] : -1;
      row[2] = first.p[b] ? index.p[first.p[b]] : -1;
      row[3] = parent.p[b] == 1 ? -1 : index.p[parent.p[b]];
    }
    memcpy(points + 2 * at, pts.p + 2 * (int64_t)start.p[b],
           (size_t)npts.p[b] * 2 * sizeof(int32_t));
    at += npts.p[b];
    offsets[i + 1] = (int32_t)at;
  }
  rc = 0;
done:
  free(parent.p);
  free(hole.p);
  free(start.p);
  free(npts.p);
  free(pts.p);
  free(first.p);
  free(next.p);
  free(prev.p);
  free(index.p);
  free(order.p);
  return rc;
}
