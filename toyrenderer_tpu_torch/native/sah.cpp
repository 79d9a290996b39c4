// Binned-SAH 8-wide BVH builder for the frozen RT topology.
//
// Counterpart of the reference's driver-side BLAS build (one BLAS per
// mesh, built once at load — source/Visual.cpp:509-542): the topology
// is frozen at scene load and only AABBs refit per frame.  The morton
// complete tree it replaces needs no pointers but overlaps siblings
// badly; measured on the courtyard probe-packet workload an adaptive
// SAH tree halves leaf visits (see ops/bvh_sah.py).
//
// Output contract (all caller-allocated):
//   child[n_nodes][8]  i32: >=0 child node id, <0 leaf (-(leaf_id+1)),
//                           INT32_MIN absent slot
//   axis[n_nodes]      i32: split axis (children sorted along it asc.)
//   leaf[n_leaves][leaf_tris] i32 triangle ids, -1 padded
//   counts[3]          {n_nodes, n_leaves, max_depth}
// Nodes are emitted grouped by depth (BFS order), root = node 0, so a
// bottom-up refit can process contiguous depth ranges.
//
// Build: 16-bin binned SAH binary splits, collapsed 3 levels deep into
// 8-wide nodes; equal-count median fallback when a split degenerates.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

struct BuildNode {
    float lo[3], hi[3];
    int32_t kids[8];          // temp-node ids, or <0 leaf, INT32_MIN none
    int32_t axis = 0;
    int32_t depth = 0;
    float center(const int) const;
};

struct Ctx {
    const float* tlo;
    const float* thi;
    std::vector<float> cent;       // (n, 3)
    std::vector<int32_t> ids;      // scratch triangle-id pool
    std::vector<BuildNode> nodes;  // temp tree
    std::vector<int32_t> leaf_of;  // flat leaf tri lists
    std::vector<int32_t> leaf_off; // leaf start offsets (count = size-1)
    int32_t leaf_tris;
    int32_t nbins;
};

void bounds_of(const Ctx& c, const int32_t* ids, int64_t n, float* lo,
               float* hi) {
    for (int a = 0; a < 3; ++a) { lo[a] = 3e38f; hi[a] = -3e38f; }
    for (int64_t i = 0; i < n; ++i) {
        const float* l = c.tlo + 3 * ids[i];
        const float* h = c.thi + 3 * ids[i];
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], l[a]);
            hi[a] = std::max(hi[a], h[a]);
        }
    }
}

inline float harea(const float lo[3], const float hi[3]) {
    float d0 = std::max(hi[0] - lo[0], 0.f);
    float d1 = std::max(hi[1] - lo[1], 0.f);
    float d2 = std::max(hi[2] - lo[2], 0.f);
    return d0 * d1 + d1 * d2 + d2 * d0;
}

// one binned-SAH binary split of ids[0..n); returns split point (elements
// are partitioned in place), or -1 to keep as one part
int64_t split_sah(Ctx& c, int32_t* ids, int64_t n, int* out_axis) {
    if (n <= c.leaf_tris) return -1;
    float clo[3] = {3e38f, 3e38f, 3e38f};
    float chi[3] = {-3e38f, -3e38f, -3e38f};
    for (int64_t i = 0; i < n; ++i) {
        const float* cc = c.cent.data() + 3 * ids[i];
        for (int a = 0; a < 3; ++a) {
            clo[a] = std::min(clo[a], cc[a]);
            chi[a] = std::max(chi[a], cc[a]);
        }
    }
    const int NB = c.nbins;
    float best_cost = 3e38f;
    int best_axis = -1, best_bin = -1;
    std::vector<float> blo(NB * 3), bhi(NB * 3);
    std::vector<int64_t> cnt(NB);
    for (int a = 0; a < 3; ++a) {
        float ext = chi[a] - clo[a];
        if (ext <= 1e-9f) continue;
        std::fill(cnt.begin(), cnt.end(), 0);
        for (int k = 0; k < NB; ++k)
            for (int j = 0; j < 3; ++j) {
                blo[k * 3 + j] = 3e38f;
                bhi[k * 3 + j] = -3e38f;
            }
        float inv = NB / ext;
        for (int64_t i = 0; i < n; ++i) {
            int32_t t = ids[i];
            int k = std::min<int>((c.cent[3 * t + a] - clo[a]) * inv,
                                  NB - 1);
            cnt[k]++;
            for (int j = 0; j < 3; ++j) {
                blo[k * 3 + j] = std::min(blo[k * 3 + j],
                                          c.tlo[3 * t + j]);
                bhi[k * 3 + j] = std::max(bhi[k * 3 + j],
                                          c.thi[3 * t + j]);
            }
        }
        // sweep: prefix/suffix areas
        float plo[3], phi[3];
        std::vector<float> suf(NB);
        float slo[3] = {3e38f, 3e38f, 3e38f};
        float shi[3] = {-3e38f, -3e38f, -3e38f};
        std::vector<int64_t> scnt(NB);
        int64_t run = 0;
        for (int k = NB - 1; k >= 0; --k) {
            for (int j = 0; j < 3; ++j) {
                slo[j] = std::min(slo[j], blo[k * 3 + j]);
                shi[j] = std::max(shi[j], bhi[k * 3 + j]);
            }
            run += cnt[k];
            suf[k] = harea(slo, shi) * run;
            scnt[k] = run;
        }
        for (int j = 0; j < 3; ++j) { plo[j] = 3e38f; phi[j] = -3e38f; }
        int64_t pre = 0;
        for (int k = 0; k < NB - 1; ++k) {
            for (int j = 0; j < 3; ++j) {
                plo[j] = std::min(plo[j], blo[k * 3 + j]);
                phi[j] = std::max(phi[j], bhi[k * 3 + j]);
            }
            pre += cnt[k];
            if (pre == 0 || scnt[k + 1] == 0) continue;
            float cost = harea(plo, phi) * pre + suf[k + 1];
            if (cost < best_cost) {
                best_cost = cost;
                best_axis = a;
                best_bin = k;
            }
        }
    }
    if (best_axis < 0) {
        // degenerate extents: equal-count median on the widest axis
        int a = 0;
        float w = -1;
        for (int j = 0; j < 3; ++j)
            if (chi[j] - clo[j] > w) { w = chi[j] - clo[j]; a = j; }
        *out_axis = a;
        int64_t h = n / 2;
        std::nth_element(ids, ids + h, ids + n,
                         [&](int32_t x, int32_t y) {
                             return c.cent[3 * x + a] < c.cent[3 * y + a];
                         });
        return h;
    }
    *out_axis = best_axis;
    float ext = chi[best_axis] - clo[best_axis];
    float inv = c.nbins / ext;
    float base = clo[best_axis];
    int32_t* mid = std::partition(
        ids, ids + n, [&](int32_t t) {
            int k = std::min<int>((c.cent[3 * t + best_axis] - base)
                                  * inv, c.nbins - 1);
            return k <= best_bin;
        });
    int64_t m = mid - ids;
    if (m == 0 || m == n) m = n / 2;   // safety (shouldn't happen)
    return m;
}

int32_t make_leaf(Ctx& c, const int32_t* ids, int64_t n) {
    int32_t lid = (int32_t)(c.leaf_off.size() - 1);
    for (int64_t i = 0; i < n; ++i) c.leaf_of.push_back(ids[i]);
    c.leaf_off.push_back((int32_t)c.leaf_of.size());
    return -(lid + 1);
}

// terminal for small subtrees (n <= 8*leaf_tris): ONE node whose
// children are ceil(n/leaf_tris) consecutive FULL leaves sliced along
// the widest centroid axis.  Row-optimal: recursive SAH splitting of
// e.g. 100 tris yields ~9 narrow nodes + 16 half-full leaves (25 rows);
// the chop yields 1 node + 9 leaves (10 rows) at ~0.93 fill — and a
// leaf visit costs the same 12 Moller-Trumbore lanes at any fill.
int32_t chop(Ctx& c, int32_t* ids, int64_t n, int depth) {
    float clo[3] = {3e38f, 3e38f, 3e38f};
    float chi[3] = {-3e38f, -3e38f, -3e38f};
    for (int64_t i = 0; i < n; ++i) {
        const float* cc = c.cent.data() + 3 * ids[i];
        for (int a = 0; a < 3; ++a) {
            clo[a] = std::min(clo[a], cc[a]);
            chi[a] = std::max(chi[a], cc[a]);
        }
    }
    int ax = 0;
    float w = -1;
    for (int a = 0; a < 3; ++a)
        if (chi[a] - clo[a] > w) { w = chi[a] - clo[a]; ax = a; }
    std::sort(ids, ids + n, [&](int32_t x, int32_t y) {
        return c.cent[3 * x + ax] < c.cent[3 * y + ax];
    });
    int32_t me = (int32_t)c.nodes.size();
    c.nodes.emplace_back();
    c.nodes[me].depth = depth;
    c.nodes[me].axis = ax;
    for (int k = 0; k < 8; ++k) c.nodes[me].kids[k] = INT32_MIN;
    int slot = 0;
    for (int64_t off = 0; off < n; off += c.leaf_tris)
        c.nodes[me].kids[slot++] =
            make_leaf(c, ids + off, std::min<int64_t>(c.leaf_tris,
                                                      n - off));
    return me;
}

// build one 8-wide node over ids[0..n): binary SAH splits refilled to
// width 8 (split the largest splittable part until 8 parts), then
// consecutive small parts merge into FULL leaves — a node row costs the
// same 512B padded VMEM bytes at any width, and a leaf visit costs the
// same 12 Moller-Trumbore lanes at any fill, so wide nodes + packed
// leaves strictly reduce both tree bytes and packet visits.
int32_t build(Ctx& c, int32_t* ids, int64_t n, int depth) {
    if (n <= c.leaf_tris && depth > 0) return make_leaf(c, ids, n);
    if (n <= c.leaf_tris * 8) return chop(c, ids, n, depth);
    int32_t me = (int32_t)c.nodes.size();
    c.nodes.emplace_back();
    c.nodes[me].depth = depth;

    struct Part { int64_t off, n; };
    Part parts[8];
    int np = 1;
    parts[0] = {0, n};
    int first_axis = -1;
    while (np < 8) {
        // split the largest part that can still split
        int big = -1;
        for (int p = 0; p < np; ++p)
            if (parts[p].n > c.leaf_tris
                && (big < 0 || parts[p].n > parts[big].n))
                big = p;
        if (big < 0) break;
        int ax;
        int64_t m = split_sah(c, ids + parts[big].off, parts[big].n,
                              &ax);
        if (m < 0) break;
        if (first_axis < 0) first_axis = ax;
        Part right = {parts[big].off + m, parts[big].n - m};
        parts[big].n = m;
        parts[np++] = right;
    }
    int ax = first_axis < 0 ? 0 : first_axis;
    c.nodes[me].axis = ax;
    // children sorted by centroid along the node axis (near-to-far
    // traversal pops by ray sign on this axis)
    std::vector<std::pair<float, Part>> order(np);
    for (int p = 0; p < np; ++p) {
        double s = 0;
        for (int64_t i = 0; i < parts[p].n; ++i)
            s += c.cent[3 * ids[parts[p].off + i] + ax];
        order[p] = {(float)(s / std::max<int64_t>(parts[p].n, 1)),
                    parts[p]};
    }
    std::sort(order.begin(), order.end(),
              [](const auto& a, const auto& b) {
                  return a.first < b.first;
              });
    // merge consecutive parts while the union still fits one leaf
    std::vector<std::vector<Part>> groups;
    int64_t run = 0;
    for (int p = 0; p < np; ++p) {
        const Part& pt = order[p].second;
        if (groups.empty() || run + pt.n > c.leaf_tris) {
            groups.push_back({pt});
            run = pt.n;
        } else {
            groups.back().push_back(pt);
            run += pt.n;
        }
    }
    for (int k = 0; k < 8; ++k) c.nodes[me].kids[k] = INT32_MIN;
    std::vector<int32_t> scratch;
    for (size_t g = 0; g < groups.size(); ++g) {
        int64_t tot = 0;
        for (const Part& pt : groups[g]) tot += pt.n;
        int32_t kid;
        if (tot <= c.leaf_tris) {
            scratch.clear();
            for (const Part& pt : groups[g])
                scratch.insert(scratch.end(), ids + pt.off,
                               ids + pt.off + pt.n);
            kid = make_leaf(c, scratch.data(), tot);
        } else {
            // a group can only exceed leaf_tris as a SINGLE part (the
            // merge loop never grows a group past leaf_tris), so the
            // range is contiguous
            kid = build(c, ids + groups[g][0].off, tot, depth + 1);
        }
        c.nodes[me].kids[g] = kid;
    }
    return me;
}

}  // namespace

extern "C" int64_t build_sah8(const float* tlo, const float* thi,
                              int64_t n, int32_t leaf_tris,
                              int32_t nbins, int64_t max_nodes,
                              int64_t max_leaves, int32_t* out_child,
                              int32_t* out_axis, int32_t* out_leaf,
                              int32_t* out_counts) {
    if (n <= 0) return -1;
    Ctx c;
    c.tlo = tlo;
    c.thi = thi;
    c.leaf_tris = leaf_tris;
    c.nbins = nbins;
    c.cent.resize(n * 3);
    for (int64_t i = 0; i < n * 3; ++i)
        c.cent[i] = 0.5f * (tlo[i] + thi[i]);
    c.ids.resize(n);
    for (int64_t i = 0; i < n; ++i) c.ids[i] = (int32_t)i;
    c.leaf_off.push_back(0);
    c.nodes.reserve(n / 4 + 8);

    build(c, c.ids.data(), n, 0);   // root = temp node 0

    int64_t n_nodes = (int64_t)c.nodes.size();
    int64_t n_leaves = (int64_t)c.leaf_off.size() - 1;
    if (n_nodes > max_nodes || n_leaves > max_leaves) return -1;

    // relabel nodes grouped by depth (stable) so refit can walk
    // contiguous depth ranges bottom-up
    int max_d = 0;
    for (auto& nd : c.nodes) max_d = std::max(max_d, nd.depth);
    std::vector<int32_t> remap(n_nodes);
    int32_t next = 0;
    for (int d = 0; d <= max_d; ++d)
        for (int64_t i = 0; i < n_nodes; ++i)
            if (c.nodes[i].depth == d) remap[i] = next++;
    for (int64_t i = 0; i < n_nodes; ++i) {
        int32_t o = remap[i];
        out_axis[o] = c.nodes[i].axis;
        for (int k = 0; k < 8; ++k) {
            int32_t kid = c.nodes[i].kids[k];
            out_child[o * 8 + k] =
                (kid == INT32_MIN) ? INT32_MIN
                : (kid < 0) ? kid : remap[kid];
        }
    }
    for (int64_t l = 0; l < n_leaves; ++l) {
        int32_t s = c.leaf_off[l], e = c.leaf_off[l + 1];
        for (int32_t k = 0; k < leaf_tris; ++k)
            out_leaf[l * leaf_tris + k] = (s + k < e) ? c.leaf_of[s + k]
                                                      : -1;
    }
    out_counts[0] = (int32_t)n_nodes;
    out_counts[1] = (int32_t)n_leaves;
    out_counts[2] = max_d;
    return 0;
}
