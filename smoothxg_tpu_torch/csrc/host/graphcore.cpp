// graphcore: native host graph kernel for smoothxg_tpu.
//
// Implements the hot host-side graph transform of the pipeline —
// unchop (merge maximal non-branching, path-safe runs) + topological sort +
// dense renumbering — over flat arrays, replacing the reference's
// odgi::algorithms::unchop / topological_order usage
// (reference: deps/odgi via src/main.cpp:1011, src/smooth.cpp:538-550).
//
// Graph encoding (matches smoothxg_tpu.graph.mutable):
//   handle  = node_id << 1 | is_reverse          (node ids 1-based, dense)
//   side    = node_id << 1 | end                 (end 1 = right/forward-out)
//   edge    = pair of handles (from, to): connects out_side(from), in_side(to)
//
// Build: g++ -O3 -shared -fPIC -o libgraphcore.so graphcore.cpp
#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <string>
#include <queue>
#include <algorithm>
#include <unordered_set>
#include <unordered_map>

using std::vector;

namespace {

static inline int64_t hid(int64_t h) { return h >> 1; }
static inline bool hrev(int64_t h) { return h & 1; }
static inline int64_t flip(int64_t h) { return h ^ 1; }
static inline int64_t out_side(int64_t h) { return (h >> 1 << 1) | (hrev(h) ? 0 : 1); }
static inline int64_t in_side(int64_t h) { return (h >> 1 << 1) | (hrev(h) ? 1 : 0); }
// handle entering through a side (follow right); exiting (follow left)
static inline int64_t entering(int64_t side) { return (side >> 1 << 1) | ((side & 1) ? 1 : 0); }
static inline int64_t exiting(int64_t side) { return (side >> 1 << 1) | ((side & 1) ? 0 : 1); }

struct Graph {
    int64_t n = 0;                       // node count
    vector<uint8_t> seq;                 // concatenated forward sequences
    vector<int64_t> node_off;            // n+1
    vector<int64_t> edges;               // 2*m handle pairs
    vector<int64_t> path_off;            // n_paths+1
    vector<int64_t> steps;               // handles
};

static const uint8_t* comp_table() {
    static uint8_t t[256];
    static bool init = false;
    if (!init) {
        for (int i = 0; i < 256; ++i) t[i] = (uint8_t)i;
        const char* a = "ATCGUARYSWKMBVDHNatcguaryswkmbvdhn";
        const char* b = "TAGCATYRSWMKVBHDNtagcatyrswmkvbhdn";
        for (int i = 0; a[i]; ++i) t[(uint8_t)a[i]] = (uint8_t)b[i];
        init = true;
    }
    return t;
}

struct Result {
    Graph g;
};

// adjacency over sides
struct Adj {
    vector<vector<int64_t>> at;   // side -> sides
    explicit Adj(int64_t n) : at(2 * (n + 1)) {}
    void add(int64_t sa, int64_t sb) {
        auto &la = at[sa];
        if (std::find(la.begin(), la.end(), sb) != la.end()) return;
        la.push_back(sb);
        if (sa != sb) at[sb].push_back(sa);
    }
};

// unchop + toposort + renumber over flat arrays (gc_unchop's body).
Result* unchop_core(
    int64_t n_nodes,
    const uint8_t* seq_buf, const int64_t* node_off,
    int64_t n_edges, const int64_t* edge_pairs,
    int64_t n_paths, const int64_t* path_off, const int64_t* steps_in,
    int do_unchop, int do_toposort)
{
    const int64_t n = n_nodes;
    Adj adj(n);
    for (int64_t i = 0; i < n_edges; ++i) {
        int64_t a = edge_pairs[2 * i], b = edge_pairs[2 * i + 1];
        adj.add(out_side(a), in_side(b));
    }

    // node -> (path, rank) occurrences
    vector<int64_t> occ_cnt(n + 1, 0);
    int64_t total_steps = path_off[n_paths];
    for (int64_t i = 0; i < total_steps; ++i) occ_cnt[hid(steps_in[i])]++;
    vector<int64_t> occ_start(n + 2, 0);
    for (int64_t i = 1; i <= n; ++i) occ_start[i + 1] = occ_start[i] + occ_cnt[i];
    vector<int64_t> occ_path(total_steps), occ_rank(total_steps);
    {
        vector<int64_t> cur(occ_start.begin(), occ_start.end() - 1);
        for (int64_t p = 0; p < n_paths; ++p) {
            for (int64_t r = path_off[p]; r < path_off[p + 1]; ++r) {
                int64_t nd = hid(steps_in[r]);
                int64_t c = cur[nd]++;
                occ_path[c] = p;
                occ_rank[c] = r;   // global rank; path-local = r - path_off[p]
            }
        }
    }

    // succ/pred over oriented handles where a merge is allowed
    // (structural degree-1 on both sides + every path traversal continues)
    vector<int64_t> succ(2 * (n + 1), -1), pred(2 * (n + 1), -1);
    auto linkable = [&](int64_t a, int64_t b) -> bool {
        if (hid(a) == hid(b)) return false;
        for (int64_t c = occ_start[hid(a)]; c < occ_start[hid(a) + 1]; ++c) {
            int64_t p = occ_path[c], r = occ_rank[c];
            int64_t h = steps_in[r];
            if (h == a) {
                if (r + 1 >= path_off[p + 1] || steps_in[r + 1] != b) return false;
            } else if (h == flip(a)) {
                if (r <= path_off[p] || steps_in[r - 1] != flip(b)) return false;
            }
        }
        for (int64_t c = occ_start[hid(b)]; c < occ_start[hid(b) + 1]; ++c) {
            int64_t p = occ_path[c], r = occ_rank[c];
            int64_t h = steps_in[r];
            if (h == b) {
                if (r <= path_off[p] || steps_in[r - 1] != a) return false;
            } else if (h == flip(b)) {
                if (r + 1 >= path_off[p + 1] || steps_in[r + 1] != flip(a)) return false;
            }
        }
        return true;
    };

    if (do_unchop) {
        for (int64_t nd = 1; nd <= n; ++nd) {
            for (int orient = 0; orient < 2; ++orient) {
                int64_t h = (nd << 1) | orient;
                const auto &rs = adj.at[out_side(h)];
                if (rs.size() != 1) continue;
                int64_t b = entering(rs[0]);
                if (adj.at[in_side(b)].size() != 1) continue;
                if (!linkable(h, b)) continue;
                succ[h] = b;
                pred[b] = h;
            }
        }
    }

    // chains over forward representatives
    vector<int64_t> chain_of(n + 1, -1);     // node -> chain idx
    vector<int64_t> chain_pos(n + 1, 0);
    vector<int64_t> chain_rep(n + 1, 0);     // oriented handle in chain
    vector<vector<int64_t>> chains;
    vector<char> visited(n + 1, 0);
    for (int64_t nd = 1; nd <= n; ++nd) {
        if (visited[nd]) continue;
        int64_t start = nd << 1;
        std::unordered_set<int64_t> guard{nd};
        while (pred[start] != -1) {
            int64_t p = pred[start];
            if (guard.count(hid(p))) break;
            start = p;
            guard.insert(hid(p));
        }
        vector<int64_t> chain{start};
        visited[hid(start)] = 1;
        int64_t cur = start;
        while (succ[cur] != -1) {
            int64_t nx = succ[cur];
            if (visited[hid(nx)]) break;
            chain.push_back(nx);
            visited[hid(nx)] = 1;
            cur = nx;
        }
        int64_t ci = (int64_t)chains.size();
        for (size_t pos = 0; pos < chain.size(); ++pos) {
            chain_of[hid(chain[pos])] = ci;
            chain_pos[hid(chain[pos])] = (int64_t)pos;
            chain_rep[hid(chain[pos])] = chain[pos];
        }
        chains.push_back(std::move(chain));
    }

    // merged sequences
    const uint8_t* C = comp_table();
    int64_t n_new = (int64_t)chains.size();
    vector<std::string> new_seq(n_new);
    for (int64_t ci = 0; ci < n_new; ++ci) {
        std::string s;
        for (int64_t h : chains[ci]) {
            int64_t nd = hid(h);
            int64_t a = node_off[nd - 1], b = node_off[nd];
            if (!hrev(h)) {
                s.append((const char*)seq_buf + a, (size_t)(b - a));
            } else {
                for (int64_t i = b - 1; i >= a; --i) s.push_back((char)C[seq_buf[i]]);
            }
        }
        new_seq[ci] = std::move(s);
    }

    auto map_handle = [&](int64_t h) -> int64_t {
        int64_t ci = chain_of[hid(h)];
        int64_t nh = ((ci + 1) << 1);
        return (h == chain_rep[hid(h)]) ? nh : flip(nh);
    };

    // edges: drop internal chain edges, remap the rest
    vector<int64_t> new_edges;
    {
        std::unordered_set<int64_t> seen;
        for (int64_t i = 0; i < n_edges; ++i) {
            int64_t a = edge_pairs[2 * i], b = edge_pairs[2 * i + 1];
            int64_t ca = chain_of[hid(a)], cb = chain_of[hid(b)];
            if (ca == cb && chains[ca].size() > 1) {
                int64_t pa = chain_pos[hid(a)], pb = chain_pos[hid(b)];
                bool fwd = a == chain_rep[hid(a)] && b == chain_rep[hid(b)] && pb == pa + 1;
                bool rev = flip(a) == chain_rep[hid(a)] && flip(b) == chain_rep[hid(b)] && pa == pb + 1;
                if (fwd || rev) continue;
            }
            int64_t ma = map_handle(a), mb = map_handle(b);
            int64_t sa = out_side(ma), sb = in_side(mb);
            int64_t key = (std::min(sa, sb) << 32) | std::max(sa, sb);
            if (seen.insert(key).second) {
                new_edges.push_back(ma);
                new_edges.push_back(mb);
            }
        }
    }

    // paths: consume whole chains
    vector<int64_t> new_path_off(n_paths + 1, 0);
    vector<int64_t> new_steps;
    for (int64_t p = 0; p < n_paths; ++p) {
        int64_t i = path_off[p];
        while (i < path_off[p + 1]) {
            int64_t h = steps_in[i];
            int64_t ci = chain_of[hid(h)];
            new_steps.push_back(map_handle(h));
            i += (int64_t)chains[ci].size() > 1 ? (int64_t)chains[ci].size() : 1;
        }
        new_path_off[p + 1] = (int64_t)new_steps.size();
    }

    // topological order + renumber
    vector<int64_t> order(n_new);
    for (int64_t i = 0; i < n_new; ++i) order[i] = i + 1;
    if (do_toposort) {
        Adj a2(n_new);
        for (size_t i = 0; i < new_edges.size(); i += 2)
            a2.add(out_side(new_edges[i]), in_side(new_edges[i + 1]));
        vector<int64_t> indeg(n_new + 1, 0);
        for (int64_t ndp = 1; ndp <= n_new; ++ndp)
            indeg[ndp] = (int64_t)a2.at[in_side(ndp << 1)].size();
        std::priority_queue<int64_t, vector<int64_t>, std::greater<int64_t>> ready;
        vector<char> emitted(n_new + 1, 0);
        for (int64_t ndp = 1; ndp <= n_new; ++ndp)
            if (indeg[ndp] == 0) ready.push(ndp);
        order.clear();
        int64_t scan_from = 1;
        while ((int64_t)order.size() < n_new) {
            if (ready.empty()) {
                while (scan_from <= n_new && emitted[scan_from]) ++scan_from;
                if (scan_from > n_new) break;
                ready.push(scan_from);
            }
            int64_t ndp = ready.top(); ready.pop();
            if (emitted[ndp]) continue;
            emitted[ndp] = 1;
            order.push_back(ndp);
            for (int64_t sb : a2.at[out_side(ndp << 1)]) {
                int64_t m = hid(entering(sb));
                if (!emitted[m] && --indeg[m] == 0) ready.push(m);
            }
        }
    }

    // renumber into result
    vector<int64_t> remap(n_new + 1, 0);
    for (int64_t i = 0; i < (int64_t)order.size(); ++i) remap[order[i]] = i + 1;

    Result* res = new Result();
    Graph &g = res->g;
    g.n = n_new;
    g.node_off.assign(n_new + 1, 0);
    {
        vector<const std::string*> by_new(n_new + 1);
        for (int64_t old = 1; old <= n_new; ++old) by_new[remap[old]] = &new_seq[old - 1];
        for (int64_t i = 1; i <= n_new; ++i) {
            g.node_off[i] = g.node_off[i - 1] + (int64_t)by_new[i]->size();
        }
        g.seq.resize((size_t)g.node_off[n_new]);
        for (int64_t i = 1; i <= n_new; ++i)
            memcpy(g.seq.data() + g.node_off[i - 1], by_new[i]->data(), by_new[i]->size());
    }
    auto renum = [&](int64_t h) { return (remap[hid(h)] << 1) | (h & 1); };
    g.edges.reserve(new_edges.size());
    for (int64_t h : new_edges) g.edges.push_back(renum(h));
    g.path_off = std::move(new_path_off);
    g.steps.resize(new_steps.size());
    for (size_t i = 0; i < new_steps.size(); ++i) g.steps[i] = renum(new_steps[i]);
    return res;
}

} // namespace

extern "C" {

// Perform unchop + toposort + renumber. Returns an opaque result handle.
void* gc_unchop(
    int64_t n_nodes,
    const uint8_t* seq_buf, const int64_t* node_off,
    int64_t n_edges, const int64_t* edge_pairs,
    int64_t n_paths, const int64_t* path_off, const int64_t* steps_in,
    int do_unchop, int do_toposort)
{
    return unchop_core(n_nodes, seq_buf, node_off, n_edges, edge_pairs,
                       n_paths, path_off, steps_in, do_unchop, do_toposort);
}

// The block graph of a POA graph, unchopped and toposorted as gc_unchop
// does, in one call (pipeline/smooth.py:_finalize_block; reference:
// build_odgi_SPOA / build_odgi_abPOA, src/smooth.cpp:2507-2609).
//   base[n_poa]                      each POA node's base
//   seq_off[n_seqs+1], seq_nodes     each unique sequence's POA node path
//   pad                              steps trimmed from each end of them
//   range_seq[n_ranges], range_rev   each output path's unique sequence,
//                                    and whether it runs reversed + flipped
//   has_cons, cons[n_cons]           a last path on the consensus nodes
//   abpoa                            the consensus keeps only nodes that
//                                    the trimmed sequence paths use
// Nodes are the used POA nodes, 1 bp each, renumbered 1..n in POA id
// order; edges come from consecutive path steps in the order
// MutableGraph.create_edges_from_paths + edges_array gives them (by the
// lower side, then by the smallest (out side, in side) pair that makes
// the edge), which fixes the order of the edges gc_unchop returns.
void* gc_block_unchop(
    int64_t n_poa, const uint8_t* base,
    int64_t n_seqs, const int64_t* seq_off, const int64_t* seq_nodes,
    int64_t pad, int64_t n_ranges, const int64_t* range_seq,
    const uint8_t* range_rev, int has_cons, int64_t n_cons,
    const int64_t* cons, int abpoa, int do_unchop, int do_toposort)
{
    // trimmed sequence paths [ts, te): empty when no longer than 2 * pad
    vector<int64_t> ts(n_seqs), te(n_seqs);
    vector<int64_t> newid(n_poa, 0);
    for (int64_t s = 0; s < n_seqs; ++s) {
        ts[s] = seq_off[s] + pad;
        te[s] = std::max(seq_off[s + 1] - pad, ts[s]);
        for (int64_t i = ts[s]; i < te[s]; ++i) newid[seq_nodes[i]] = 1;
    }
    vector<int64_t> cons_steps;
    if (has_cons) {
        for (int64_t i = 0; i < n_cons; ++i)
            if (!abpoa || newid[cons[i]]) cons_steps.push_back(cons[i]);
        for (int64_t v : cons_steps) newid[v] = 1;
    }
    int64_t n = 0;
    for (int64_t v = 0; v < n_poa; ++v)
        if (newid[v]) newid[v] = ++n;

    vector<uint8_t> seq(n);
    vector<int64_t> node_off(n + 1);
    for (int64_t v = 0; v < n_poa; ++v)
        if (newid[v]) seq[newid[v] - 1] = base[v];
    for (int64_t i = 0; i <= n; ++i) node_off[i] = i;

    int64_t n_paths = n_ranges + (has_cons ? 1 : 0);
    vector<int64_t> path_off(n_paths + 1, 0);
    vector<int64_t> steps;
    int64_t n_steps = (int64_t)cons_steps.size();
    for (int64_t r = 0; r < n_ranges; ++r)
        n_steps += te[range_seq[r]] - ts[range_seq[r]];
    steps.reserve(n_steps);
    for (int64_t r = 0; r < n_ranges; ++r) {
        int64_t s = range_seq[r];
        if (range_rev[r]) {
            for (int64_t i = te[s] - 1; i >= ts[s]; --i)
                steps.push_back(newid[seq_nodes[i]] << 1 | 1);
        } else {
            for (int64_t i = ts[s]; i < te[s]; ++i)
                steps.push_back(newid[seq_nodes[i]] << 1);
        }
        path_off[r + 1] = (int64_t)steps.size();
    }
    if (has_cons) {
        for (int64_t v : cons_steps) steps.push_back(newid[v] << 1);
        path_off[n_paths] = (int64_t)steps.size();
    }

    // a step pair (a, b) joins out_side(a) = a ^ 1 to in_side(b) = b;
    // the distinct (out side, in side) keys, ascending: the pairs bucketed
    // by out side, each bucket (a node's few neighbours) sorted alone
    int64_t n_sides = 2 * (n + 1);
    vector<int64_t> bucket(n_sides + 1, 0);
    for (int64_t p = 0; p < n_paths; ++p)
        for (int64_t i = path_off[p] + 1; i < path_off[p + 1]; ++i)
            ++bucket[(steps[i - 1] ^ 1) + 1];
    for (int64_t sd = 0; sd < n_sides; ++sd) bucket[sd + 1] += bucket[sd];
    vector<int64_t> to(bucket[n_sides]);
    {
        vector<int64_t> cur(bucket.begin(), bucket.end() - 1);
        for (int64_t p = 0; p < n_paths; ++p)
            for (int64_t i = path_off[p] + 1; i < path_off[p + 1]; ++i)
                to[cur[steps[i - 1] ^ 1]++] = steps[i];
    }
    vector<uint64_t> keys;
    for (int64_t sd = 0; sd < n_sides; ++sd) {
        auto b = to.begin() + bucket[sd], e = to.begin() + bucket[sd + 1];
        std::sort(b, e);
        for (auto it = b; it != e; it = std::upper_bound(it, e, *it))
            keys.push_back((uint64_t)sd << 32 | (uint64_t)*it);
    }
    // (canonical key, smallest directed key): keys ascend, so the first
    // of each canonical key in a stable sort is its smallest
    vector<std::pair<uint64_t, uint64_t>> canon(keys.size());
    for (size_t i = 0; i < keys.size(); ++i) {
        uint64_t sa = keys[i] >> 32, sb = keys[i] & 0xFFFFFFFFu;
        canon[i] = {std::min(sa, sb) << 32 | std::max(sa, sb), keys[i]};
    }
    std::stable_sort(canon.begin(), canon.end(),
                     [](const auto& x, const auto& y) { return x.first < y.first; });
    canon.erase(std::unique(canon.begin(), canon.end(),
                            [](const auto& x, const auto& y) { return x.first == y.first; }),
                canon.end());
    std::sort(canon.begin(), canon.end(), [](const auto& x, const auto& y) {
        uint64_t lx = x.first >> 32, ly = y.first >> 32;
        return lx != ly ? lx < ly : x.second < y.second;
    });
    vector<int64_t> edges(2 * canon.size());
    for (size_t i = 0; i < canon.size(); ++i) {
        edges[2 * i] = (int64_t)(canon[i].first >> 32) ^ 1;
        edges[2 * i + 1] = (int64_t)(canon[i].first & 0xFFFFFFFFu);
    }
    return unchop_core(n, seq.data(), node_off.data(),
                       (int64_t)canon.size(), edges.data(), n_paths,
                       path_off.data(), steps.data(), do_unchop, do_toposort);
}

int64_t gc_n_nodes(void* r) { return ((Result*)r)->g.n; }
int64_t gc_seq_len(void* r) { return (int64_t)((Result*)r)->g.seq.size(); }
int64_t gc_n_edges(void* r) { return (int64_t)((Result*)r)->g.edges.size() / 2; }
int64_t gc_n_steps(void* r) { return (int64_t)((Result*)r)->g.steps.size(); }

void gc_copy(void* r, uint8_t* seq_buf, int64_t* node_off, int64_t* edges,
             int64_t* path_off, int64_t* steps, int64_t n_paths) {
    Graph &g = ((Result*)r)->g;
    // empty vectors may return data()==nullptr; memcpy with a null source
    // is UB even for size 0
    if (!g.seq.empty()) memcpy(seq_buf, g.seq.data(), g.seq.size());
    if (!g.node_off.empty())
        memcpy(node_off, g.node_off.data(), sizeof(int64_t) * (g.n + 1));
    if (!g.edges.empty())
        memcpy(edges, g.edges.data(), sizeof(int64_t) * g.edges.size());
    if (!g.path_off.empty())
        memcpy(path_off, g.path_off.data(), sizeof(int64_t) * (n_paths + 1));
    if (!g.steps.empty())
        memcpy(steps, g.steps.data(), sizeof(int64_t) * g.steps.size());
}

void gc_free(void* r) { delete (Result*)r; }

// ---------------------------------------------------------------------------
// Block-finder sweep (reference: smoothable_blocks, src/blocks.cpp:240-315,
// finalize_block :106-230, toposplit_block :43-105).  Exact port of the
// python sweep in pipeline/blocks.py — the remaining O(steps) interpreter-
// bound prep stage at pod scale.  Semantics are identical (same traversal
// sort, path-jump / seen-run splits, longest-first stable order, first-seen
// component order), asserted block-for-block by tests/test_blocks_native.py.
//
// path_pos is the per-path position array with steps(p)+1 entries per path:
//   pos(p, r) = path_pos[path_off[p] + p + r]
// ---------------------------------------------------------------------------

struct BFRange { int64_t pid, begin, end, length; };

struct BFResult {
    vector<int64_t> block_off;     // n_blocks+1 prefix into ranges
    vector<BFRange> ranges;
};

struct BFUf {
    // union-find over node ids, local to one block
    std::unordered_map<int64_t, int64_t> parent;
    int64_t find(int64_t x) {
        while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
        return x;
    }
    void add(int64_t x) { if (!parent.count(x)) parent[x] = x; }
    void unite(int64_t a, int64_t b) {
        add(a); add(b);
        int64_t ra = find(a), rb = find(b);
        if (ra != rb) parent[rb] = ra;
    }
};

void* bf_sweep(int64_t n_nodes, int64_t n_paths,
               const int64_t* node_len,
               const int64_t* node_steps_start,   // [n_nodes+1]
               const int64_t* step_path,
               const int64_t* step_rank,
               const int64_t* path_off,           // [n_paths+1]
               const int64_t* path_pos,           // see header comment
               const int64_t* path_steps,         // handles, [path_off[P]]
               const int64_t* ejump,              // [n_nodes+1]
               int64_t max_block_weight,
               int64_t max_block_path_length,
               int64_t max_path_jump,
               int64_t max_edge_jump,
               int32_t order_longest) {
    auto* res = new BFResult();
    // seen flags, flat over the step ranks of each path
    vector<uint8_t> seen((size_t)path_off[n_paths], 0);
    auto seen_at = [&](int64_t p, int64_t r) -> uint8_t& {
        return seen[(size_t)(path_off[p] + r)];
    };
    auto pos_of = [&](int64_t p, int64_t r) -> int64_t {
        return path_pos[path_off[p] + p + r];
    };
    auto step_of = [&](int64_t p, int64_t r) -> int64_t {
        return path_steps[path_off[p] + r];
    };

    vector<int64_t> block_handles;
    int64_t total_path_length = 0;
    // dense coverage accumulators + active list (python: path_coverage dict)
    vector<int64_t> cov_bp(n_paths, 0), cov_n(n_paths, 0);
    vector<int64_t> cov_active;

    vector<std::pair<int64_t, int64_t>> traversals;
    vector<BFRange> block_ranges;

    auto finalize_block = [&]() {
        traversals.clear();
        for (int64_t nid : block_handles) {
            for (int64_t i = node_steps_start[nid - 1];
                 i < node_steps_start[nid]; ++i) {
                if (!seen_at(step_path[i], step_rank[i]))
                    traversals.emplace_back(step_path[i], step_rank[i]);
            }
        }
        block_handles.clear();
        std::sort(traversals.begin(), traversals.end());

        // pass 1: split on path change / positional jump
        struct R1 { int64_t pid, begin, last; };
        vector<R1> r1;
        for (auto& t : traversals) {
            int64_t pid = t.first, rank = t.second;
            if (!r1.empty() && r1.back().pid == pid) {
                int64_t llast = r1.back().last;
                int64_t gap = pos_of(pid, rank) -
                    (pos_of(pid, llast) +
                     node_len[(step_of(pid, llast) >> 1) - 1]);
                if (gap <= max_path_jump) { r1.back().last = rank; continue; }
            }
            r1.push_back({pid, rank, rank});
        }

        // pass 2: split each range on already-seen steps
        block_ranges.clear();
        for (auto& rr : r1) {
            int64_t end_excl = rr.last + 1;
            const uint8_t* s = &seen[(size_t)path_off[rr.pid]];
            int64_t r = rr.begin;
            while (r < end_excl) {
                const void* f0 = memchr(s + r, 0, (size_t)(end_excl - r));
                if (!f0) break;
                int64_t cb = (const uint8_t*)f0 - s;
                const void* f1 = memchr(s + cb + 1, 1,
                                        (size_t)(end_excl - cb - 1));
                int64_t ce = f1 ? ((const uint8_t*)f1 - s) : end_excl;
                block_ranges.push_back({rr.pid, cb, ce, 0});
                r = ce + 1;
            }
        }

        // mark kept steps, compute lengths
        int64_t total = 0;
        for (auto& pr : block_ranges) {
            memset(&seen[(size_t)(path_off[pr.pid] + pr.begin)], 1,
                   (size_t)(pr.end - pr.begin));
            pr.length = pos_of(pr.pid, pr.end) - pos_of(pr.pid, pr.begin);
            total += pr.length;
        }
        if (total <= 0) return;
        std::stable_sort(block_ranges.begin(), block_ranges.end(),
                         [order_longest](const BFRange& a, const BFRange& b) {
                             return order_longest ? a.length > b.length
                                                  : a.length < b.length;
                         });

        // toposplit: weakly-connected components over consecutive node
        // pairs of each range (first-seen component order over ranges)
        BFUf uf;
        for (auto& pr : block_ranges) {
            int64_t prev = -1;
            for (int64_t r = pr.begin; r < pr.end; ++r) {
                int64_t nid = step_of(pr.pid, r) >> 1;
                if (prev >= 0 && prev != nid) uf.unite(prev, nid);
                else uf.add(nid);
                prev = nid;
            }
        }
        std::unordered_map<int64_t, int64_t> comp_index;
        vector<vector<BFRange>> comps;
        for (auto& pr : block_ranges) {
            int64_t nid = step_of(pr.pid, pr.begin) >> 1;
            uf.add(nid);
            int64_t root = uf.find(nid);
            auto it = comp_index.find(root);
            int64_t ci;
            if (it == comp_index.end()) {
                ci = (int64_t)comps.size();
                comp_index.emplace(root, ci);
                comps.emplace_back();
            } else ci = it->second;
            comps[(size_t)ci].push_back(pr);
        }
        for (auto& comp : comps) {
            for (auto& pr : comp) res->ranges.push_back(pr);
            res->block_off.push_back((int64_t)res->ranges.size());
        }
    };

    vector<int64_t> unseen_here;
    for (int64_t nid = 1; nid <= n_nodes; ++nid) {
        int64_t handle_length = node_len[nid - 1];
        int64_t sequence_to_add = 0;
        int64_t us0 = node_steps_start[nid - 1], us1 = node_steps_start[nid];
        // the unseen list is captured BEFORE a possible finalize (which
        // can mark some of this node's steps seen through merged spans);
        // the coverage update below uses this pre-finalize snapshot,
        // matching pipeline/blocks.py exactly
        unseen_here.clear();
        for (int64_t i = us0; i < us1; ++i)
            if (!seen_at(step_path[i], step_rank[i])) {
                sequence_to_add += handle_length;
                unseen_here.push_back(step_path[i]);
            }

        int64_t max_path_length = 0;
        int64_t nbh = (int64_t)block_handles.size();
        for (int64_t pid : cov_active) {
            double bp = (double)cov_bp[pid];
            int64_t nsteps = cov_n[pid];
            double denom = (nsteps < nbh || nbh == 0)
                ? 1.0 : (double)nsteps / (double)nbh;
            // python: int(bp / denom + 0.5) — round half up for positives
            int64_t est = (int64_t)(bp / denom + 0.5) + handle_length;
            if (est > max_path_length) max_path_length = est;
        }

        if (!block_handles.empty() &&
            (total_path_length + sequence_to_add > max_block_weight ||
             (max_edge_jump && ejump[nid] > max_edge_jump) ||
             max_path_length > max_block_path_length)) {
            finalize_block();
            total_path_length = 0;
            for (int64_t pid : cov_active) { cov_bp[pid] = 0; cov_n[pid] = 0; }
            cov_active.clear();
        }

        total_path_length += sequence_to_add;
        for (int64_t pid : unseen_here) {
            if (cov_n[pid] == 0 && cov_bp[pid] == 0)
                cov_active.push_back(pid);
            cov_bp[pid] += handle_length;
            cov_n[pid] += 1;
        }
        block_handles.push_back(nid);
    }
    if (!block_handles.empty()) finalize_block();
    return res;
}

int64_t bf_n_blocks(void* r) {
    return (int64_t)((BFResult*)r)->block_off.size();
}
int64_t bf_n_ranges(void* r) {
    return (int64_t)((BFResult*)r)->ranges.size();
}
void bf_copy(void* r, int64_t* block_off, int64_t* pid, int64_t* begin,
             int64_t* end, int64_t* length) {
    auto* b = (BFResult*)r;
    block_off[0] = 0;
    for (size_t i = 0; i < b->block_off.size(); ++i)
        block_off[i + 1] = b->block_off[i];
    for (size_t i = 0; i < b->ranges.size(); ++i) {
        pid[i] = b->ranges[i].pid;
        begin[i] = b->ranges[i].begin;
        end[i] = b->ranges[i].end;
        length[i] = b->ranges[i].length;
    }
}
void bf_free(void* r) { delete (BFResult*)r; }

} // extern "C"
