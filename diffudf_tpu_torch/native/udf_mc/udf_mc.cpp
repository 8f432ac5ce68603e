// Native sign propagation for UDF marching cubes (MeshUDF-style extraction).
//
// The one inherently-sequential component of the framework: assign a pseudo
// sign (+1/-1) to every near-surface grid vertex so the unsigned distance
// field becomes locally signable for marching cubes.
//
// Division of labour with the Python side (extract/meshudf.py):
//   * Python computes per-edge signed weights w = rel · confidence for the
//     three positive-axis edge families (robust value+direction relations);
//     sign(w) = +1 (same side) / −1 (surface crossing), |w| = confidence.
//   * This module runs Prim's maximum-confidence spanning-forest
//     propagation per connected component, seeded at each component's
//     minimum-UDF vertex — the deterministic core of the reference's
//     priority BFS with deferred low-confidence votes
//     (_marching_cubes_lewiner_cy.pyx:1584-1697).
//   * Python then applies vectorised majority relaxation on top.
//
// Build: g++ -O3 -shared -fPIC -o libudf_mc.so udf_mc.cpp (native/build.py
// does this at first use, into the ignored build directory)

#include <cstdint>
#include <queue>
#include <vector>
#include <algorithm>
#include <cmath>

namespace {

struct Edge {
  float conf;
  int32_t from;
  int32_t to;
  int8_t rel;  // +1 same side, -1 flip
  bool operator<(const Edge& o) const { return conf < o.conf; }  // max-heap
};

}  // namespace

extern "C" {

// udf:          n0*n1*n2 floats (C order)
// participate:  n0*n1*n2 bytes (0/1)
// wx:           (n0-1)*n1*n2 signed weights for +x edges
// wy:           n0*(n1-1)*n2 signed weights for +y edges
// wz:           n0*n1*(n2-1) signed weights for +z edges
// signs_out:    n0*n1*n2 int8, receives +1 / -1 (non-participating stay +1)
void sign_voting(const float* udf, const uint8_t* participate,
                 const float* wx, const float* wy, const float* wz,
                 int32_t n0, int32_t n1, int32_t n2, int8_t* signs_out) {
  const int64_t n = static_cast<int64_t>(n0) * n1 * n2;
  const int64_t stride0 = static_cast<int64_t>(n1) * n2;
  const int64_t stride1 = n2;
  const int64_t strides[3] = {stride0, stride1, 1};
  const int32_t dims[3] = {n0, n1, n2};

  std::fill(signs_out, signs_out + n, static_cast<int8_t>(1));
  std::vector<uint8_t> visited(n, 0);

  // seeds ordered by ascending UDF among participating vertices
  std::vector<int32_t> order;
  order.reserve(n / 8);
  for (int64_t i = 0; i < n; ++i)
    if (participate[i]) order.push_back(static_cast<int32_t>(i));
  std::sort(order.begin(), order.end(),
            [&](int32_t a, int32_t b) { return udf[a] < udf[b]; });

  auto coord = [&](int64_t idx, int32_t c[3]) {
    c[0] = static_cast<int32_t>(idx / stride0);
    c[1] = static_cast<int32_t>((idx / stride1) % n1);
    c[2] = static_cast<int32_t>(idx % n2);
  };

  // weight of the +axis edge starting at vertex with coords c
  auto edge_weight = [&](const int32_t c[3], int axis) -> float {
    // slab shapes: axis-0 edges laid out as (n0-1, n1, n2) etc.
    if (axis == 0) {
      return wx[(static_cast<int64_t>(c[0]) * n1 + c[1]) * n2 + c[2]];
    } else if (axis == 1) {
      return wy[(static_cast<int64_t>(c[0]) * (n1 - 1) + c[1]) * n2 + c[2]];
    }
    return wz[(static_cast<int64_t>(c[0]) * n1 + c[1]) * (n2 - 1) + c[2]];
  };

  std::priority_queue<Edge> heap;

  auto push_edges = [&](int32_t v) {
    int32_t c[3];
    coord(v, c);
    for (int axis = 0; axis < 3; ++axis) {
      for (int sgn = -1; sgn <= 1; sgn += 2) {
        const int32_t cc = c[axis] + sgn;
        if (cc < 0 || cc >= dims[axis]) continue;
        const int64_t nb = v + sgn * strides[axis];
        if (!participate[nb] || visited[nb]) continue;
        int32_t base[3] = {c[0], c[1], c[2]};
        if (sgn < 0) base[axis] -= 1;  // edge starts at the lower coord
        const float w = edge_weight(base, axis);
        heap.push(Edge{std::fabs(w), v, static_cast<int32_t>(nb),
                       static_cast<int8_t>(w < 0.0f ? -1 : 1)});
      }
    }
  };

  for (int32_t seed : order) {
    if (visited[seed]) continue;
    visited[seed] = 1;
    push_edges(seed);
    while (!heap.empty()) {
      Edge e = heap.top();
      heap.pop();
      if (visited[e.to]) continue;
      visited[e.to] = 1;
      signs_out[e.to] = static_cast<int8_t>(signs_out[e.from] * e.rel);
      push_edges(e.to);
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Voted-sign BFS with deferred queues — the reference MeshUDF semantics.
//
// Re-implementation (from behavioral study, not translation) of the
// reference's region-growing sign assignment
// (_marching_cubes_lewiner_cy.pyx:1116-1774):
//
//   * per-vertex sign = sign of the sum over the 6 axis neighbours of
//     sign(neighbour) * edge_vote(dir_v, dir_n, direction), where the vote
//     is +1 when the two direction vectors diverge along the edge (the two
//     endpoints sit in the gap between two sheets -> same side) and
//     dot(dir_v, dir_n) otherwise (pyx:1777-1807);
//   * cubes whose weakest corner confidence |sum|/votes falls below
//     `unsure_thresh` (0.707) are deferred: their 6 neighbours are probed
//     first (signs computed but nothing committed/emitted), then the cube
//     is re-processed with the extra context (pyx:1584-1697);
//   * vote-less corners fall back to the cube anchor direction, sign-
//     aligned through the first committed corner (pyx:1311-1375);
//   * cubes with a non-trivial MC configuration are parked in a third
//     queue and, like every BFS-reached cube, only emit faces if >= 2 of
//     their crossing vertices already exist in the built mesh
//     (pyx:1744-1750 + check_the_big_switch) — this suppresses the
//     parity-conflict seams around open-sheet borders;
//   * seed cubes (raster scan over unvisited gated cells) emit
//     unconditionally and start a new connected component.
//
// Outputs a full sign grid plus the per-cell emission mask; triangulation
// happens on the Python side (extract/table_mc.py).

#include <deque>
#include <tuple>

namespace votebfs {

// corner offsets in (axis0, axis1, axis2), reference processing order
static const int CO[8][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, 1}, {0, 1, 0},
    {1, 0, 0}, {1, 0, 1}, {1, 1, 1}, {1, 1, 0},
};
// anchor preference order (reference pyx:1311-1375 corner labels 1,2,4,3,…)
static const int ANCHOR[8] = {0, 1, 3, 2, 4, 5, 7, 6};

struct Ctx {
  const float* udf;
  const float* dirs;
  const uint8_t* trivial;
  int n0, n1, n2;
  int64_t s0, s1;  // strides (s2 == 1)
  float avg_max, max_max, unsure;
  int support_min;
  int8_t* sign;                  // 0 = unset
  std::vector<uint8_t> committed;
  std::vector<uint8_t> visited;  // per cell
  std::vector<uint8_t> meshed;   // per grid edge: vertex already in mesh
  uint8_t* emit;                 // per cell
  std::deque<int64_t> main_q, unsure_q, nontrivial_q;
};

static inline float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

static inline float edge_vote(const float* g1, const float* g2, int axis,
                              int orient) {
  const float p1 = g1[axis] * orient, p2 = g2[axis] * orient;
  if (p2 > 0.0f && p1 < 0.0f) return 1.0f;  // diverging: same region
  return dot3(g1, g2);
}

static inline int8_t sgn(float v) {
  return v > 0.0f ? 1 : (v < 0.0f ? -1 : 0);
}

// returns my marching-cubes bit for a corner offset (table_mc convention:
// bit0 = axis0 offset, bit1 = axis1, bit2 = axis2; inside = signed < 0)
static inline int mask_bit(int c) {
  return CO[c][0] * 1 + CO[c][1] * 2 + CO[c][2] * 4;
}

enum Result { NO_CUBE, NO_FACES, EMITTED, DEFER_UNSURE, DEFER_NT, NO_SUPPORT };

// Process one cube.
//   probe:  compute provisional signs only; never commit/emit/defer.
//   seed:   raster-scan seed — emit unconditionally.
// Deferral (unsure / non-trivial) applies only when neither flag is set
// and other work is pending (!main_q.empty()).
static Result process_cube(Ctx& c, int64_t ci, int64_t cj, int64_t ck,
                           bool probe, bool seed) {
  const int64_t cell = (ci * (c.n1 - 1) + cj) * (c.n2 - 1) + ck;
  if (c.visited[cell]) return NO_CUBE;

  int64_t gv[8];
  float uvals[8];
  float avg = 0.0f, mx = 0.0f;
  for (int v = 0; v < 8; ++v) {
    gv[v] = (ci + CO[v][0]) * c.s0 + (cj + CO[v][1]) * c.s1 + (ck + CO[v][2]);
    uvals[v] = c.udf[gv[v]];
    avg += uvals[v];
    if (uvals[v] > mx) mx = uvals[v];
  }
  avg *= 0.125f;
  if (!(avg < c.avg_max && mx <= c.max_max)) return NO_CUBE;

  const int dims[3] = {c.n0, c.n1, c.n2};
  const int64_t strides[3] = {c.s0, c.s1, 1};

  int votes[8];
  for (int v = 0; v < 8; ++v) {
    votes[v] = 0;
    const int64_t g = gv[v];
    if (c.committed[g]) { votes[v] = 1; continue; }
    if (uvals[v] == 0.0f) { votes[v] = 1; c.sign[g] = 0; continue; }

    float s = 0.0f;
    int coords[3] = {int(ci + CO[v][0]), int(cj + CO[v][1]), int(ck + CO[v][2])};
    for (int axis = 0; axis < 3; ++axis) {
      for (int orient = -1; orient <= 1; orient += 2) {
        int maxd = 1;
        for (int i = 1; i <= maxd; ++i) {
          const int cc = coords[axis] + i * orient;
          if (cc < 0 || cc >= dims[axis]) break;
          const int64_t nb = g + int64_t(i) * orient * strides[axis];
          if (c.udf[nb] == 0.0f) { if (i == maxd) ++maxd; continue; }
          if (c.sign[nb] == 0) continue;
          ++votes[v];
          s += float(c.sign[nb]) *
               edge_vote(c.dirs + 3 * g, c.dirs + 3 * nb, axis, orient);
        }
      }
    }
    // unsure-cube deferral: weak aggregate vote and other work pending
    if (votes[v] >= 1 && !c.main_q.empty() && !seed &&
        std::fabs(s) / votes[v] < c.unsure) {
      return probe ? NO_CUBE : DEFER_UNSURE;
    }
    c.sign[g] = sgn(s);
  }

  // anchor-direction fallback for vote-less corners
  bool all_voted = true;
  for (int v = 0; v < 8; ++v) all_voted = all_voted && votes[v] >= 1;
  if (!all_voted) {
    const float* base = nullptr;
    float anchor_sign = 1.0f;
    for (int k = 0; k < 8 && !base; ++k) {
      const int64_t g = gv[ANCHOR[k]];
      const float* d = c.dirs + 3 * g;
      if (c.committed[g] &&
          std::fabs(d[0]) + std::fabs(d[1]) + std::fabs(d[2]) > 0.0f) {
        anchor_sign = float(c.sign[g] < 0 ? -1 : 1);
        base = d;
      }
    }
    for (int k = 0; k < 8 && !base; ++k) {
      const int64_t g = gv[ANCHOR[k]];
      const float* d = c.dirs + 3 * g;
      if (std::fabs(d[0]) + std::fabs(d[1]) + std::fabs(d[2]) > 0.0f) base = d;
    }
    if (base) {
      for (int v = 0; v < 8; ++v) {
        if (votes[v] >= 1) continue;
        const float s = anchor_sign * dot3(base, c.dirs + 3 * gv[v]);
        if (!probe && !seed && !c.main_q.empty() &&
            std::fabs(s) < c.unsure) {
          return DEFER_UNSURE;
        }
        c.sign[gv[v]] = sgn(s);
      }
    }
  }
  if (probe) return NO_CUBE;

  for (int v = 0; v < 8; ++v) c.committed[gv[v]] = 1;

  int mask = 0;
  for (int v = 0; v < 8; ++v) {
    const float sv = float(c.sign[gv[v]]) * uvals[v];
    if (sv < 0.0f) mask |= 1 << mask_bit(v);
  }
  if (mask == 0 || mask == 255) {
    c.visited[cell] = 1;
    return NO_FACES;
  }

  if (!c.trivial[mask] && (!c.main_q.empty() || !c.unsure_q.empty())) {
    return DEFER_NT;  // caller pushes onto the non-trivial queue
  }

  // cut edges of this cube (grid-edge key = low-vertex * 3 + axis)
  int64_t cut[12];
  int n_cut = 0;
  for (int a = 0; a < 8; ++a) {
    for (int axis = 0; axis < 3; ++axis) {
      if (CO[a][axis] != 0) continue;
      int b = -1;  // corner index with this axis offset +1, others equal
      for (int t = 0; t < 8; ++t) {
        if (CO[t][axis] == 1 && CO[t][(axis + 1) % 3] == CO[a][(axis + 1) % 3]
            && CO[t][(axis + 2) % 3] == CO[a][(axis + 2) % 3]) { b = t; break; }
      }
      const bool ia = float(c.sign[gv[a]]) * uvals[a] < 0.0f;
      const bool ib = float(c.sign[gv[b]]) * uvals[b] < 0.0f;
      if (ia != ib) cut[n_cut++] = gv[a] * 3 + axis;
    }
  }

  if (!seed) {
    int support = 0;
    for (int e = 0; e < n_cut; ++e) support += c.meshed[cut[e]] ? 1 : 0;
    if (support < c.support_min) return NO_SUPPORT;  // stays unvisited
  }

  c.visited[cell] = 1;
  c.emit[cell] = 1;
  for (int e = 0; e < n_cut; ++e) c.meshed[cut[e]] = 1;
  return EMITTED;
}

static void push_neighbours(Ctx& c, int64_t ci, int64_t cj, int64_t ck) {
  const int64_t cd[3] = {c.n0 - 1, c.n1 - 1, c.n2 - 1};
  const int64_t d[6][3] = {{1, 0, 0}, {-1, 0, 0}, {0, 1, 0},
                           {0, -1, 0}, {0, 0, 1}, {0, 0, -1}};
  for (int k = 0; k < 6; ++k) {
    const int64_t i = ci + d[k][0], j = cj + d[k][1], l = ck + d[k][2];
    if (i < 0 || j < 0 || l < 0 || i >= cd[0] || j >= cd[1] || l >= cd[2])
      continue;
    c.main_q.push_back((i * cd[1] + j) * cd[2] + l);
  }
}

}  // namespace votebfs

extern "C" {

// udf:   n0*n1*n2 float32 (C order), non-negative pseudo distances
// dirs:  n0*n1*n2*3 float32 direction field (points toward the surface)
// trivial: 256 bytes, 1 where the MC configuration is safe to mesh eagerly
// sign_out: n0*n1*n2 int8 (+1/-1; 0 where never reached)
// emit_out: (n0-1)*(n1-1)*(n2-1) uint8, 1 where faces should be produced
void vote_bfs(const float* udf, const float* dirs, int32_t n0, int32_t n1,
              int32_t n2, float voxel, float avg_thresh, float max_thresh,
              float unsure_thresh, int32_t support_min,
              const uint8_t* trivial, int8_t* sign_out, uint8_t* emit_out) {
  using namespace votebfs;
  const int64_t n = int64_t(n0) * n1 * n2;
  const int64_t n_cells = int64_t(n0 - 1) * (n1 - 1) * (n2 - 1);

  Ctx c;
  c.udf = udf;
  c.dirs = dirs;
  c.trivial = trivial;
  c.n0 = n0; c.n1 = n1; c.n2 = n2;
  c.s0 = int64_t(n1) * n2;
  c.s1 = n2;
  c.avg_max = avg_thresh * voxel;
  c.max_max = max_thresh * voxel;
  c.unsure = unsure_thresh;
  c.support_min = support_min;
  c.sign = sign_out;
  std::fill(sign_out, sign_out + n, static_cast<int8_t>(0));
  std::fill(emit_out, emit_out + n_cells, static_cast<uint8_t>(0));
  c.committed.assign(n, 0);
  c.visited.assign(n_cells, 0);
  c.meshed.assign(3 * n, 0);
  c.emit = emit_out;

  const int64_t cd1 = n1 - 1, cd2 = n2 - 1;
  auto cell_coords = [&](int64_t cell, int64_t& i, int64_t& j, int64_t& k) {
    i = cell / (cd1 * cd2);
    j = (cell / cd2) % cd1;
    k = cell % cd2;
  };

  for (int64_t ci = 0; ci < n0 - 1; ++ci)
  for (int64_t cj = 0; cj < n1 - 1; ++cj)
  for (int64_t ck = 0; ck < n2 - 1; ++ck) {
    {
      const int64_t cell = (ci * cd1 + cj) * cd2 + ck;
      if (c.visited[cell]) continue;
    }
    const Result r = process_cube(c, ci, cj, ck, /*probe=*/false, /*seed=*/true);
    if (r != EMITTED) continue;
    push_neighbours(c, ci, cj, ck);

    // breadth-first exploration with the two deferred queues
    bool visit_neighbours = true;
    while (!c.main_q.empty() || !c.unsure_q.empty() ||
           !c.nontrivial_q.empty()) {
      int64_t cell;
      bool probe = false;
      if (c.main_q.empty()) {
        if (c.unsure_q.empty()) {
          cell = c.nontrivial_q.front();
          c.nontrivial_q.pop_front();
        } else {
          cell = c.unsure_q.front();
          if (visit_neighbours) {
            int64_t i, j, k;
            cell_coords(cell, i, j, k);
            if (c.visited[cell]) { c.unsure_q.pop_front(); continue; }
            push_neighbours(c, i, j, k);
            visit_neighbours = false;
            continue;
          }
          c.unsure_q.pop_front();
          visit_neighbours = true;  // fall through: process the unsure cube
        }
      } else {
        cell = c.main_q.front();
        c.main_q.pop_front();
        probe = !visit_neighbours;  // neighbours of an unsure cube
      }

      int64_t i, j, k;
      cell_coords(cell, i, j, k);
      const Result r2 = process_cube(c, i, j, k, probe, /*seed=*/false);
      switch (r2) {
        case EMITTED:
          push_neighbours(c, i, j, k);
          break;
        case DEFER_UNSURE:
          if (visit_neighbours) c.unsure_q.push_back(cell);
          break;
        case DEFER_NT:
          c.nontrivial_q.push_back(cell);
          break;
        default:
          break;  // NO_CUBE / NO_FACES / NO_SUPPORT
      }
    }
  }
}

}  // extern "C"
