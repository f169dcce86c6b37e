// Host-side rasterizer: OpenCV's drawing primitives (imgproc/drawing.cpp),
// reproduced pixel for pixel for the calls the synthetic data, the dummy
// datasets and the COCO instance masks make (data/raster.py binds it).
//
// Points are int64 in fixed point with `shift` fractional bits, as OpenCV
// takes them (XY_SHIFT = 16 inside); an image is a C-contiguous H x W array
// of `pix` bytes a pixel, and a colour is `pix` raw bytes (the caller
// converts the colour as cv::scalarToRawData does). Only 8-connected lines
// (LINE_8), OpenCV's default, are drawn.
//
// Build: ops/kernels/build.py::host_library("raster").

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int XY_SHIFT = 16;
constexpr int64_t XY_ONE = int64_t(1) << XY_SHIFT;

struct Pt {
  int64_t x, y;
};

struct Canvas {
  uint8_t* data;
  int h, w, pix;
  const uint8_t* color;

  uint8_t* row(int y) const { return data + size_t(y) * w * pix; }
  void put(int x, int y) const {
    if (0 <= x && x < w && 0 <= y && y < h) memcpy(row(y) + size_t(x) * pix, color, pix);
  }
  // Pixels xl..xr of row y, both inside the image.
  void hline(int y, int xl, int xr) const {
    uint8_t* p = row(y) + size_t(xl) * pix;
    for (int x = xl; x <= xr; ++x, p += pix) memcpy(p, color, pix);
  }
};

// cv::clipLine on int64 points.
bool clip_line(int64_t width, int64_t height, Pt& p1, Pt& p2) {
  if (width <= 0 || height <= 0) return false;
  int64_t right = width - 1, bottom = height - 1;
  int64_t &x1 = p1.x, &y1 = p1.y, &x2 = p2.x, &y2 = p2.y;
  int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
  int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
  if ((c1 & c2) == 0 && (c1 | c2) != 0) {
    int64_t a;
    if (c1 & 12) {
      a = c1 < 8 ? 0 : bottom;
      x1 += int64_t(double(a - y1) * (x2 - x1) / (y2 - y1));
      y1 = a;
      c1 = (x1 < 0) + (x1 > right) * 2;
    }
    if (c2 & 12) {
      a = c2 < 8 ? 0 : bottom;
      x2 += int64_t(double(a - y2) * (x2 - x1) / (y2 - y1));
      y2 = a;
      c2 = (x2 < 0) + (x2 > right) * 2;
    }
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
      if (c1) {
        a = c1 == 1 ? 0 : right;
        y1 += int64_t(double(a - x1) * (y2 - y1) / (x2 - x1));
        x1 = a;
        c1 = 0;
      }
      if (c2) {
        a = c2 == 1 ? 0 : right;
        y2 += int64_t(double(a - x2) * (y2 - y1) / (x2 - x1));
        x2 = a;
        c2 = 0;
      }
    }
  }
  return (c1 | c2) == 0;
}

// cv::Line: an 8-connected line between integer points, walked left to
// right as cv::LineIterator walks it.
void line(const Canvas& c, Pt p1, Pt p2) {
  if (p1.x < 0 || p1.x >= c.w || p2.x < 0 || p2.x >= c.w || p1.y < 0 || p1.y >= c.h || p2.y < 0 ||
      p2.y >= c.h) {
    if (!clip_line(c.w, c.h, p1, p2)) return;
  }
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  if (dx < 0) {
    dx = -dx;
    dy = -dy;
    std::swap(p1, p2);
  }
  int64_t sx = 1, sy = 1;
  if (dy < 0) {
    dy = -dy;
    sy = -1;
  }
  bool vert = dy > dx;
  if (vert) std::swap(dx, dy);
  int64_t err = dx - (dy + dy), plus = dx + dx, minus = -(dy + dy);
  int64_t x = p1.x, y = p1.y;
  for (int64_t i = 0; i <= dx; ++i) {
    c.put(int(x), int(y));
    bool step_minor = err < 0;
    err += minus + (step_minor ? plus : 0);
    if (vert) {
      y += sy;
      if (step_minor) x += sx;
    } else {
      x += sx;
      if (step_minor) y += sy;
    }
  }
}

// cv::Line2: a line between XY_SHIFT fixed-point points.
void line2(const Canvas& c, Pt p1, Pt p2) {
  if (!clip_line(int64_t(c.w) << XY_SHIFT, int64_t(c.h) << XY_SHIFT, p1, p2)) return;
  int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
  int64_t j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
  int64_t i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
  int64_t x_step, y_step;
  int ecount;
  if (ax > ay) {
    dy = (dy ^ j) - j;
    if (j) std::swap(p1, p2);
    x_step = XY_ONE;
    y_step = (dy * XY_ONE) / (ax | 1);
    ecount = int((p2.x - p1.x) >> XY_SHIFT);
  } else {
    dx = (dx ^ i) - i;
    if (i) std::swap(p1, p2);
    x_step = (dx * XY_ONE) / (ay | 1);
    y_step = XY_ONE;
    ecount = int((p2.y - p1.y) >> XY_SHIFT);
  }
  p1.x += XY_ONE >> 1;
  p1.y += XY_ONE >> 1;
  c.put(int((p2.x + (XY_ONE >> 1)) >> XY_SHIFT), int((p2.y + (XY_ONE >> 1)) >> XY_SHIFT));
  if (ax > ay) {
    p1.x >>= XY_SHIFT;
    for (; ecount >= 0; --ecount) {
      c.put(int(p1.x), int(p1.y >> XY_SHIFT));
      p1.x++;
      p1.y += y_step;
    }
  } else {
    p1.y >>= XY_SHIFT;
    for (; ecount >= 0; --ecount) {
      c.put(int(p1.x >> XY_SHIFT), int(p1.y));
      p1.x += x_step;
      p1.y++;
    }
  }
}

// cv::FillConvexPoly (LINE_8).
void fill_convex_poly(const Canvas& c, const Pt* v, int npts, int shift) {
  struct {
    int idx, di;
    int64_t x, dx;
    int ye;
  } edge[2];
  int delta = 1 << shift >> 1;
  int imin = 0, edges = npts;
  constexpr int64_t delta1 = XY_ONE >> 1, delta2 = XY_ONE >> 1;
  Pt p0 = v[npts - 1];
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  int64_t xmin = v[0].x, xmax = v[0].x, ymin = v[0].y, ymax = v[0].y;
  for (int i = 0; i < npts; ++i) {
    Pt p = v[i];
    if (p.y < ymin) {
      ymin = p.y;
      imin = i;
    }
    ymax = std::max(ymax, p.y);
    xmax = std::max(xmax, p.x);
    xmin = std::min(xmin, p.x);
    p.x <<= XY_SHIFT - shift;
    p.y <<= XY_SHIFT - shift;
    if (shift == 0) {
      line(c, Pt{p0.x >> XY_SHIFT, p0.y >> XY_SHIFT}, Pt{p.x >> XY_SHIFT, p.y >> XY_SHIFT});
    } else {
      line2(c, p0, p);
    }
    p0 = p;
  }
  xmin = (xmin + delta) >> shift;
  xmax = (xmax + delta) >> shift;
  ymin = (ymin + delta) >> shift;
  ymax = (ymax + delta) >> shift;
  if (npts < 3 || int(xmax) < 0 || int(ymax) < 0 || int(xmin) >= c.w || int(ymin) >= c.h) return;
  ymax = std::min<int64_t>(ymax, c.h - 1);
  edge[0].idx = edge[1].idx = imin;
  int y = int(ymin);
  edge[0].ye = edge[1].ye = y;
  edge[0].di = 1;
  edge[1].di = npts - 1;
  edge[0].x = edge[1].x = -XY_ONE;
  edge[0].dx = edge[1].dx = 0;
  do {
    for (int i = 0; i < 2; ++i) {
      if (y >= edge[i].ye) {
        int idx0 = edge[i].idx, di = edge[i].di;
        int idx = idx0 + di;
        if (idx >= npts) idx -= npts;
        for (; edges-- > 0;) {
          int ty = int((v[idx].y + delta) >> shift);
          if (ty > y) {
            int64_t xs = v[idx0].x, xe = v[idx].x;
            if (shift != XY_SHIFT) {
              xs <<= XY_SHIFT - shift;
              xe <<= XY_SHIFT - shift;
            }
            edge[i].ye = ty;
            edge[i].dx = ((xe - xs) * 2 + (int64_t(ty) - y)) / (2 * (int64_t(ty) - y));
            edge[i].x = xs;
            edge[i].idx = idx;
            break;
          }
          idx0 = idx;
          idx += di;
          if (idx >= npts) idx -= npts;
        }
      }
    }
    if (edges < 0) break;
    if (y >= 0) {
      int left = 0, right = 1;
      if (edge[0].x > edge[1].x) left = 1, right = 0;
      int xx1 = int((edge[left].x + delta1) >> XY_SHIFT);
      int xx2 = int((edge[right].x + delta2) >> XY_SHIFT);
      if (xx2 >= 0 && xx1 < c.w) {
        if (xx1 < 0) xx1 = 0;
        if (xx2 >= c.w) xx2 = c.w - 1;
        c.hline(y, xx1, xx2);
      }
    }
    edge[0].x += edge[0].dx;
    edge[1].x += edge[1].dx;
  } while (++y <= int(ymax));
}

struct PolyEdge {
  int y0 = 0, y1 = 0;
  int64_t x = 0, dx = 0;
  PolyEdge* next = nullptr;
};

// cv::CollectPolyEdges (LINE_8, no offset) as OpenCV 5 collects: draws
// each edge's line too. An edge with an end outside the image takes its x
// from the clipped integer line, and its rows from that line too unless
// the clipped line is flat (then it keeps its own rows, at a constant x).
void collect_poly_edges(const Canvas& c, const Pt* v, int count, std::vector<PolyEdge>& edges, int shift) {
  int delta = (1 << shift) >> 1;
  Pt pt0 = v[count - 1], pt1;
  pt0.x = pt0.x << (XY_SHIFT - shift);
  pt0.y = (pt0.y + delta) >> shift;
  for (int i = 0; i < count; ++i, pt0 = pt1) {
    pt1 = v[i];
    pt1.x = pt1.x << (XY_SHIFT - shift);
    pt1.y = (pt1.y + delta) >> shift;
    Pt pt0c = pt0, pt1c = pt1;
    Pt t0{(pt0.x + (XY_ONE >> 1)) >> XY_SHIFT, pt0.y}, t1{(pt1.x + (XY_ONE >> 1)) >> XY_SHIFT, pt1.y};
    line(c, t0, t1);
    if (t0.x < 0 || t0.x >= c.w || t1.x < 0 || t1.x >= c.w || t0.y < 0 || t0.y >= c.h || t1.y < 0 ||
        t1.y >= c.h) {
      clip_line(c.w, c.h, t0, t1);
      if (t0.y != t1.y) {
        pt0c.y = t0.y;
        pt1c.y = t1.y;
      }
      pt0c.x = t0.x << XY_SHIFT;
      pt1c.x = t1.x << XY_SHIFT;
    }
    if (pt0.y == pt1.y) continue;
    PolyEdge e;
    e.dx = (pt1c.x - pt0c.x) / (pt1c.y - pt0c.y);
    if (pt0.y < pt1.y) {
      e.y0 = int(pt0.y);
      e.y1 = int(pt1.y);
      e.x = pt0c.x + (pt0.y - pt0c.y) * e.dx;
    } else {
      e.y0 = int(pt1.y);
      e.y1 = int(pt0.y);
      e.x = pt1c.x + (pt1.y - pt1c.y) * e.dx;
    }
    edges.push_back(e);
  }
}

// cv::FillEdgeCollection (LINE_8) as OpenCV 5 fills: each span takes the
// pixels whose centres lie between its two edges, ceil(x_left) to
// floor(x_right).
void fill_edge_collection(const Canvas& c, std::vector<PolyEdge>& edges) {
  int total = int(edges.size());
  if (total < 2) return;
  int y_max = INT_MIN, y_min = INT_MAX;
  int64_t x_max = -1, x_min = INT64_MAX;
  for (const PolyEdge& e1 : edges) {
    int64_t x1 = e1.x + (e1.y1 - e1.y0) * e1.dx;
    y_min = std::min(y_min, e1.y0);
    y_max = std::max(y_max, e1.y1);
    x_min = std::min({x_min, e1.x, x1});
    x_max = std::max({x_max, e1.x, x1});
  }
  if (y_max < 0 || y_min >= c.h || x_max < 0 || x_min >= (int64_t(c.w) << XY_SHIFT)) return;
  std::sort(edges.begin(), edges.end(), [](const PolyEdge& e1, const PolyEdge& e2) {
    return e1.y0 - e2.y0 ? e1.y0 < e2.y0 : e1.x - e2.x ? e1.x < e2.x : e1.dx < e2.dx;
  });
  PolyEdge tmp;
  tmp.y0 = INT_MAX;
  edges.push_back(tmp);
  int i = 0;
  tmp.next = nullptr;
  PolyEdge* e = &edges[0];
  y_max = std::min(y_max, c.h);
  for (int y = e->y0; y < y_max; ++y) {
    PolyEdge *last, *prelast, *keep_prelast;
    int draw = 0;
    bool clipline = y < 0;
    prelast = &tmp;
    last = tmp.next;
    while (last || e->y0 == y) {
      if (last && last->y1 == y) {
        prelast->next = last->next;
        last = last->next;
        continue;
      }
      keep_prelast = prelast;
      if (last && (e->y0 > y || last->x < e->x)) {
        prelast = last;
        last = last->next;
      } else if (i < total) {
        prelast->next = e;
        e->next = last;
        prelast = e;
        e = &edges[++i];
      } else {
        break;
      }
      if (draw) {
        if (!clipline) {
          int x1, x2;
          if (keep_prelast->x > prelast->x) {
            x1 = int((prelast->x + XY_ONE - 1) >> XY_SHIFT);
            x2 = int(keep_prelast->x >> XY_SHIFT);
          } else {
            x1 = int((keep_prelast->x + XY_ONE - 1) >> XY_SHIFT);
            x2 = int(prelast->x >> XY_SHIFT);
          }
          if (x1 < c.w && x2 >= 0) {
            if (x1 < 0) x1 = 0;
            if (x2 >= c.w) x2 = c.w - 1;
            c.hline(y, x1, x2);
          }
        }
        keep_prelast->x += keep_prelast->dx;
        prelast->x += prelast->dx;
      }
      draw ^= 1;
    }
    // Bubble-sort the active list by x.
    keep_prelast = nullptr;
    do {
      prelast = &tmp;
      last = tmp.next;
      PolyEdge* last_exchange = nullptr;
      while (last != keep_prelast && last->next != nullptr) {
        PolyEdge* te = last->next;
        if (last->x > te->x) {
          prelast->next = te;
          last->next = te->next;
          te->next = last;
          prelast = te;
          last_exchange = prelast;
        } else {
          prelast = last;
          last = te;
        }
      }
      if (last_exchange == nullptr) break;
      keep_prelast = last_exchange;
    } while (keep_prelast != tmp.next && keep_prelast != &tmp);
  }
}

// cv::Circle, filled.
void fill_circle(const Canvas& c, int cx, int cy, int radius) {
  int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
  while (dx >= dy) {
    int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
    int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
    if (x11 < c.w && x12 >= 0 && y21 < c.h && y22 >= 0) {
      x11 = std::max(x11, 0);
      x12 = std::min(x12, c.w - 1);
      if (unsigned(y11) < unsigned(c.h)) c.hline(y11, x11, x12);
      if (unsigned(y12) < unsigned(c.h)) c.hline(y12, x11, x12);
      if (x21 < c.w && x22 >= 0) {
        x21 = std::max(x21, 0);
        x22 = std::min(x22, c.w - 1);
        if (unsigned(y21) < unsigned(c.h)) c.hline(y21, x21, x22);
        if (unsigned(y22) < unsigned(c.h)) c.hline(y22, x21, x22);
      }
    }
    dy++;
    err += plus;
    plus += 2;
    int mask = (err <= 0) - 1;
    err -= minus & mask;
    dx += mask;
    minus -= mask & 2;
  }
}

// cv::ThickLine (LINE_8); flags bit 0 / 1 round the start / end.
void thick_line(const Canvas& c, Pt p0, Pt p1, int thickness, int flags, int shift) {
  constexpr double INV_XY_ONE = 1. / XY_ONE;
  if (thickness > 1) {
    // Integer points are first clipped to the image widened by the
    // thickness on every side.
    Pt q0{p0.x + thickness, p0.y + thickness}, q1{p1.x + thickness, p1.y + thickness};
    if (!clip_line(int64_t(c.w) + 2 * thickness, int64_t(c.h) + 2 * thickness, q0, q1)) return;
    p0 = Pt{q0.x - thickness, q0.y - thickness};
    p1 = Pt{q1.x - thickness, q1.y - thickness};
  }
  p0.x <<= XY_SHIFT - shift;
  p0.y <<= XY_SHIFT - shift;
  p1.x <<= XY_SHIFT - shift;
  p1.y <<= XY_SHIFT - shift;
  if (thickness <= 1) {
    if (shift == 0) {
      line(c, Pt{(p0.x + (XY_ONE >> 1)) >> XY_SHIFT, (p0.y + (XY_ONE >> 1)) >> XY_SHIFT},
           Pt{(p1.x + (XY_ONE >> 1)) >> XY_SHIFT, (p1.y + (XY_ONE >> 1)) >> XY_SHIFT});
    } else {
      line2(c, p0, p1);
    }
    return;
  }
  double dx = (p0.x - p1.x) * INV_XY_ONE, dy = (p1.y - p0.y) * INV_XY_ONE;
  double r = dx * dx + dy * dy;
  int odd = thickness & 1;
  int64_t th = int64_t(thickness) << (XY_SHIFT - 1);
  if (std::fabs(r) > 2.220446049250313e-16) {
    r = (double(th) + odd * XY_ONE * 0.5) / std::sqrt(r);
    Pt dp{int64_t(std::nearbyint(dy * r)), int64_t(std::nearbyint(dx * r))};
    Pt pt[4] = {{p0.x + dp.x, p0.y + dp.y}, {p0.x - dp.x, p0.y - dp.y}, {p1.x - dp.x, p1.y - dp.y},
                {p1.x + dp.x, p1.y + dp.y}};
    fill_convex_poly(c, pt, 4, XY_SHIFT);
  }
  for (int i = 0; i < 2; ++i) {
    if (flags & (i + 1)) {
      int cx = int((p0.x + (XY_ONE >> 1)) >> XY_SHIFT), cy = int((p0.y + (XY_ONE >> 1)) >> XY_SHIFT);
      fill_circle(c, cx, cy, int((th + (XY_ONE >> 1)) >> XY_SHIFT));
    }
    p0 = p1;
  }
}

const Pt* as_points(const int64_t* xy) { return reinterpret_cast<const Pt*>(xy); }

}  // namespace

extern "C" {

// cv::fillConvexPoly(img, pts, color, LINE_8, shift); `xy` holds n (x, y).
int mgu_fill_convex_poly(uint8_t* img, int h, int w, int pix, const int64_t* xy, int n, const uint8_t* color,
                         int shift) {
  if (n <= 0 || shift < 0 || shift > XY_SHIFT) return 1;
  fill_convex_poly(Canvas{img, h, w, pix, color}, as_points(xy), n, shift);
  return 0;
}

// cv::fillPoly(img, contours, color, LINE_8, shift): `counts` gives each of
// the `ncont` contours' point count, their points back to back in `xy`.
int mgu_fill_poly(uint8_t* img, int h, int w, int pix, const int64_t* xy, const int* counts, int ncont,
                  const uint8_t* color, int shift) {
  if (shift < 0 || shift > XY_SHIFT) return 1;
  Canvas c{img, h, w, pix, color};
  std::vector<PolyEdge> edges;
  const Pt* v = as_points(xy);
  for (int k = 0; k < ncont; v += counts[k++]) {
    if (counts[k] > 0) collect_poly_edges(c, v, counts[k], edges, shift);
  }
  fill_edge_collection(c, edges);
  return 0;
}

// cv::polylines(img, contours, closed, color, thickness, LINE_8) on
// integer points.
int mgu_polylines(uint8_t* img, int h, int w, int pix, const int64_t* xy, const int* counts, int ncont,
                  int closed, const uint8_t* color, int thickness) {
  if (thickness < 1) return 1;
  Canvas c{img, h, w, pix, color};
  const Pt* v = as_points(xy);
  for (int k = 0; k < ncont; v += counts[k++]) {
    int count = counts[k];
    if (count <= 0) continue;
    int i = closed ? count - 1 : 0;
    int flags = 2 + !closed;
    Pt p0 = v[i];
    for (i = !closed; i < count; ++i) {
      thick_line(c, p0, v[i], thickness, flags, 0);
      p0 = v[i];
      flags = 2;
    }
  }
  return 0;
}

}  // extern "C"
