// The port's copy of `libstevi_tpu/native/maxflow.cpp`, built by
// `libstevi_tpu_torch.native.build` into `libstevi_tpu_torch/_build/`.
//
// Boykov-Kolmogorov max-flow / min-cut on FLOAT capacities.
//
// Reference parity: `graphs/graph_flow.h:48` (`maxFlowMinCut`) runs an
// augmenting-path max-flow directly on float capacities; the previous
// scipy route (`graphs/flow.py`) had to scale/round capacities to int32
// (scipy's maximum_flow is integer-only), a quantization the reference
// does not have.  This codec removes it: double-precision residual
// arithmetic, exact bottleneck augmentation, no scaling.
//
// Algorithm: Boykov & Kolmogorov's dual-tree augmenting-path search
// (grow / augment / adopt), the standard choice for vision grid graphs.
// After termination the source side of the minimum cut is recomputed by
// a BFS over strictly-positive residuals from the source (robust to
// free-node labeling at termination).
//
// Tree-parent conventions:
//   S-tree: parent[x] is the arc FROM the parent INTO x
//           (parent vertex = arcs[rev(parent[x])].head);
//   T-tree: parent[x] is the arc FROM x INTO the parent
//           (parent vertex = arcs[parent[x]].head).
// Both store the arc whose residual carries augmenting flow.
//
// C ABI (ctypes):
//   double bk_maxflow(int64_t n, int64_t m, const int64_t* edges,
//                     const double* caps, int64_t s, int64_t t,
//                     uint8_t* source_side_out);
// edges is (m, 2) row-major directed pairs; caps the matching
// capacities; source_side_out receives n bytes (1 = source side).

#include <cstdint>
#include <cstring>
#include <deque>
#include <vector>

namespace {

constexpr int kFree = 0, kSource = 1, kSink = 2;
constexpr int64_t kNoArc = -1;

struct Arc {
    int64_t head;
    int64_t next;
    double rcap;
};

struct Solver {
    int64_t n;
    std::vector<Arc> arcs;            // arcs 2i / 2i+1 are a rev pair
    std::vector<int64_t> first;
    std::vector<int8_t> tree;
    std::vector<int64_t> parent;
    std::deque<int64_t> active;
    std::deque<int64_t> orphans;
    int64_t s, t;

    Solver(int64_t n_, int64_t m, const int64_t* edges, const double* caps,
           int64_t s_, int64_t t_)
        : n(n_), first(n_, kNoArc), tree(n_, kFree), parent(n_, kNoArc),
          s(s_), t(t_) {
        arcs.reserve(2 * (size_t)m);
        for (int64_t e = 0; e < m; ++e) {
            int64_t u = edges[2 * e], v = edges[2 * e + 1];
            double c = caps[e];
            arcs.push_back({v, first[u], c < 0 ? 0.0 : c});
            first[u] = (int64_t)arcs.size() - 1;
            arcs.push_back({u, first[v], 0.0});
            first[v] = (int64_t)arcs.size() - 1;
        }
        tree[s] = kSource;
        tree[t] = kSink;
        active.push_back(s);
        active.push_back(t);
    }

    static int64_t rev(int64_t a) { return a ^ 1; }

    int64_t parent_vertex(int64_t x) const {
        int64_t pa = parent[x];
        return tree[x] == kSource ? arcs[rev(pa)].head : arcs[pa].head;
    }

    bool origin_ok(int64_t v) const {
        while (v != s && v != t) {
            if (parent[v] == kNoArc) return false;
            v = parent_vertex(v);
        }
        return true;
    }

    double run() {
        double flow = 0.0;
        while (true) {
            // -------- grow --------
            int64_t meet = kNoArc;       // arc S-side -> T-side
            while (!active.empty() && meet == kNoArc) {
                int64_t p = active.front();
                if (tree[p] == kFree) { active.pop_front(); continue; }
                int8_t tp = tree[p];
                for (int64_t a = first[p]; a != kNoArc;
                     a = arcs[a].next) {
                    double r = (tp == kSource) ? arcs[a].rcap
                                               : arcs[rev(a)].rcap;
                    if (r <= 0) continue;
                    int64_t q = arcs[a].head;
                    if (tree[q] == kFree) {
                        tree[q] = tp;
                        parent[q] = (tp == kSource) ? a : rev(a);
                        active.push_back(q);
                    } else if (tree[q] != tp) {
                        meet = (tp == kSource) ? a : rev(a);
                        break;
                    }
                }
                if (meet == kNoArc) active.pop_front();
            }
            if (meet == kNoArc) break;

            // -------- augment: s ~> u -(meet)-> v ~> t --------
            int64_t u = arcs[rev(meet)].head, v = arcs[meet].head;
            double bn = arcs[meet].rcap;
            for (int64_t x = u; x != s; x = arcs[rev(parent[x])].head)
                if (arcs[parent[x]].rcap < bn) bn = arcs[parent[x]].rcap;
            for (int64_t x = v; x != t; x = arcs[parent[x]].head)
                if (arcs[parent[x]].rcap < bn) bn = arcs[parent[x]].rcap;
            flow += bn;
            arcs[meet].rcap -= bn;
            arcs[rev(meet)].rcap += bn;
            for (int64_t x = u; x != s; ) {
                int64_t pa = parent[x];
                int64_t px = arcs[rev(pa)].head;
                arcs[pa].rcap -= bn;
                arcs[rev(pa)].rcap += bn;
                if (arcs[pa].rcap <= 0) {
                    parent[x] = kNoArc;
                    orphans.push_back(x);
                }
                x = px;
            }
            for (int64_t x = v; x != t; ) {
                int64_t pa = parent[x];
                int64_t px = arcs[pa].head;
                arcs[pa].rcap -= bn;
                arcs[rev(pa)].rcap += bn;
                if (arcs[pa].rcap <= 0) {
                    parent[x] = kNoArc;
                    orphans.push_back(x);
                }
                x = px;
            }

            // -------- adopt --------
            while (!orphans.empty()) {
                int64_t o = orphans.front();
                orphans.pop_front();
                int8_t to = tree[o];
                bool adopted = false;
                for (int64_t a = first[o]; a != kNoArc;
                     a = arcs[a].next) {
                    int64_t q = arcs[a].head;
                    if (tree[q] != to) continue;
                    // residual must point parent->o for S, o->parent
                    // for T (arc a in o's list is o -> q)
                    double r = (to == kSource) ? arcs[rev(a)].rcap
                                               : arcs[a].rcap;
                    if (r <= 0 || !origin_ok(q)) continue;
                    parent[o] = (to == kSource) ? rev(a) : a;
                    adopted = true;
                    break;
                }
                if (adopted) continue;
                for (int64_t a = first[o]; a != kNoArc;
                     a = arcs[a].next) {
                    int64_t q = arcs[a].head;
                    if (tree[q] != to) continue;
                    double r = (to == kSource) ? arcs[rev(a)].rcap
                                               : arcs[a].rcap;
                    if (r > 0) active.push_back(q);  // potential parent
                    if (parent[q] != kNoArc && parent_vertex(q) == o) {
                        parent[q] = kNoArc;          // child of o
                        orphans.push_back(q);
                    }
                }
                tree[o] = kFree;
            }
        }
        return flow;
    }

    void source_side(uint8_t* out) const {
        std::memset(out, 0, (size_t)n);
        std::vector<int64_t> st = {s};
        out[s] = 1;
        while (!st.empty()) {
            int64_t u = st.back();
            st.pop_back();
            for (int64_t a = first[u]; a != kNoArc; a = arcs[a].next) {
                if (arcs[a].rcap > 0 && !out[arcs[a].head]) {
                    out[arcs[a].head] = 1;
                    st.push_back(arcs[a].head);
                }
            }
        }
    }
};

}  // namespace

extern "C" double bk_maxflow(int64_t n, int64_t m, const int64_t* edges,
                             const double* caps, int64_t s, int64_t t,
                             uint8_t* source_side_out) {
    if (n <= 0 || s == t || s < 0 || t < 0 || s >= n || t >= n) {
        if (source_side_out && n > 0)
            std::memset(source_side_out, 0, (size_t)n);
        return 0.0;
    }
    Solver solver(n, m, edges, caps, s, t);
    double flow = solver.run();
    if (source_side_out) solver.source_side(source_side_out);
    return flow;
}
