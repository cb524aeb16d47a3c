// Native symbolic-analysis engine for the sparse/banded KKT backends.
//
// This is the host-side "scheduler" of the factorization (the role of
// CHOLMOD's analyze phase, reference: src/KKT/Cholmod/spd.jl:30-38,
// re-designed for dense tiles): given the sparsity pattern of the constraint
// matrix A it
//   1. forms the adjacency of K = A Aᵀ,
//   2. computes a reverse Cuthill-McKee ordering (George-Liu
//      pseudo-peripheral start per connected component),
//   3. runs symbolic Cholesky elimination at TILE granularity and emits the
//      padded static schedule the device numeric phase consumes
//      (tulip_tpu/kkt/sparse.py documents the schedule format).
//
// Exposed as a plain C ABI consumed via ctypes (tulip_tpu/kkt/native.py).
// All index arrays are int32, matching the Python side. The plan API is a
// handle protocol (new / emit / free) so the analysis runs exactly once.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <utility>
#include <vector>

namespace {

// Adjacency of K = A Aᵀ (excluding self-loops), from A's CSR pattern.
// adj[i] = sorted distinct rows sharing >=1 column with row i.
void build_k_adjacency(int32_t m, int32_t n, const int32_t* indptr,
                       const int32_t* indices,
                       std::vector<std::vector<int32_t>>& adj) {
    // Column -> rows map (CSC of the pattern).
    std::vector<int32_t> col_count(n, 0);
    for (int32_t i = 0; i < m; ++i)
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
            col_count[indices[p]]++;
    std::vector<int32_t> col_ptr(n + 1, 0);
    for (int32_t j = 0; j < n; ++j) col_ptr[j + 1] = col_ptr[j] + col_count[j];
    std::vector<int32_t> col_rows(indptr[m]);
    std::vector<int32_t> fill = col_ptr;
    for (int32_t i = 0; i < m; ++i)
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p)
            col_rows[fill[indices[p]]++] = i;

    adj.assign(m, {});
    std::vector<int32_t> mark(m, -1);
    for (int32_t i = 0; i < m; ++i) {
        auto& nb = adj[i];
        for (int32_t p = indptr[i]; p < indptr[i + 1]; ++p) {
            int32_t j = indices[p];
            for (int32_t q = col_ptr[j]; q < col_ptr[j + 1]; ++q) {
                int32_t r = col_rows[q];
                if (r != i && mark[r] != i) {
                    mark[r] = i;
                    nb.push_back(r);
                }
            }
        }
        std::sort(nb.begin(), nb.end());
    }
}

// BFS over the unvisited component of `start`, marking nodes with `stamp`.
// Fills `order` with the component's nodes in BFS order and `depth` with
// each node's BFS level; returns the eccentricity (max depth).
int32_t bfs_component(const std::vector<std::vector<int32_t>>& adj,
                      int32_t start, std::vector<int32_t>& order,
                      std::vector<int32_t>& depth,
                      std::vector<int32_t>& scratch_seen, int32_t stamp) {
    order.clear();
    depth.clear();
    order.push_back(start);
    depth.push_back(0);
    scratch_seen[start] = stamp;
    int32_t max_depth = 0;
    for (size_t qi = 0; qi < order.size(); ++qi) {
        int32_t u = order[qi];
        int32_t du = depth[qi];
        max_depth = std::max(max_depth, du);
        for (int32_t nb : adj[u])
            if (scratch_seen[nb] != stamp) {
                scratch_seen[nb] = stamp;
                order.push_back(nb);
                depth.push_back(du + 1);
            }
    }
    return max_depth;
}

// Reverse Cuthill-McKee over all components. Writes perm (new -> old).
void rcm(const std::vector<std::vector<int32_t>>& adj, int32_t m,
         int32_t* perm) {
    std::vector<int32_t> degree(m);
    for (int32_t i = 0; i < m; ++i)
        degree[i] = static_cast<int32_t>(adj[i].size());

    std::vector<int32_t> seen(m, -1);
    std::vector<int32_t> comp, depth;
    std::vector<int32_t> out;
    out.reserve(m);
    std::vector<char> placed(m, 0);
    int32_t stamp = 0;

    for (int32_t root = 0; root < m; ++root) {
        if (placed[root]) continue;
        // George-Liu pseudo-peripheral node: start at this component's
        // min-degree node, then repeat BFS from a min-degree node of the
        // deepest level while the eccentricity keeps growing.
        int32_t start = root;
        bfs_component(adj, start, comp, depth, seen, ++stamp);
        for (int32_t v : comp)
            if (degree[v] < degree[start]) start = v;
        int32_t ecc = -1;
        for (int iter = 0; iter < 16; ++iter) {
            int32_t new_ecc =
                bfs_component(adj, start, comp, depth, seen, ++stamp);
            if (new_ecc <= ecc) break;
            ecc = new_ecc;
            int32_t cand = start, cand_deg = INT32_MAX;
            for (size_t k = 0; k < comp.size(); ++k)
                if (depth[k] == new_ecc && degree[comp[k]] < cand_deg) {
                    cand = comp[k];
                    cand_deg = degree[comp[k]];
                }
            start = cand;
        }
        // Cuthill-McKee BFS from `start`, neighbors by increasing degree.
        std::vector<int32_t> q;
        q.push_back(start);
        placed[start] = 1;
        size_t qi = 0;
        std::vector<int32_t> nbrs;
        while (qi < q.size()) {
            int32_t u = q[qi++];
            out.push_back(u);
            nbrs.clear();
            for (int32_t nb : adj[u])
                if (!placed[nb]) nbrs.push_back(nb);
            std::sort(nbrs.begin(), nbrs.end(), [&](int32_t a, int32_t b) {
                return degree[a] != degree[b] ? degree[a] < degree[b] : a < b;
            });
            for (int32_t nb : nbrs) {
                placed[nb] = 1;
                q.push_back(nb);
            }
        }
    }
    std::reverse(out.begin(), out.end());
    std::memcpy(perm, out.data(), sizeof(int32_t) * m);
}

struct TilePlan {
    int32_t m = 0;
    int32_t nbr = 0, ntiles = 0, cmax = 0, umax = 0, advantage = 0;
    std::vector<int32_t> perm;                   // new -> old, length m
    std::vector<std::vector<int32_t>> col_rows;  // strictly-below block rows
};

// Returns 0 on success, -2 if a schedule dimension overflows int32 (the
// query-reported buffer sizes would be corrupted otherwise).
int32_t tile_symbolic(const std::vector<std::vector<int32_t>>& adj, int32_t m,
                      int32_t block, TilePlan& plan) {
    int32_t nbr = (m + block - 1) / block;
    plan.nbr = nbr;
    std::vector<int32_t> inv(m);
    for (int32_t k = 0; k < m; ++k) inv[plan.perm[k]] = k;

    // Tile-granular pattern of permuted K (strict lower triangle): collect
    // (block col, block row) pairs from the adjacency, then sort + unique.
    std::vector<std::vector<int32_t>> cols(nbr);
    {
        std::vector<std::pair<int32_t, int32_t>> pairs;
        for (int32_t old_i = 0; old_i < m; ++old_i) {
            int32_t pi = inv[old_i] / block;
            for (int32_t old_j : adj[old_i]) {
                int32_t pj = inv[old_j] / block;
                if (pi != pj)
                    pairs.emplace_back(std::min(pi, pj), std::max(pi, pj));
            }
        }
        std::sort(pairs.begin(), pairs.end());
        pairs.erase(std::unique(pairs.begin(), pairs.end()), pairs.end());
        for (const auto& [lo, hi] : pairs) cols[lo].push_back(hi);
    }

    // Right-looking symbolic elimination at tile granularity: eliminating
    // block column j connects every pair (a, b) of its below rows.
    for (int32_t j = 0; j < nbr; ++j) {
        auto& rows = cols[j];
        for (size_t x = 0; x < rows.size(); ++x)
            for (size_t y = x + 1; y < rows.size(); ++y) {
                auto& tgt = cols[rows[x]];
                if (!std::binary_search(tgt.begin(), tgt.end(), rows[y])) {
                    tgt.insert(
                        std::lower_bound(tgt.begin(), tgt.end(), rows[y]),
                        rows[y]);
                }
            }
    }

    int64_t ntiles_sub = 0;
    int64_t cmax = 1, umax = 1;
    for (auto& c : cols) {
        int64_t sz = static_cast<int64_t>(c.size());
        ntiles_sub += sz;
        cmax = std::max(cmax, sz);
        umax = std::max(umax, sz * (sz + 1) / 2);
    }
    if (umax > INT32_MAX || ntiles_sub + nbr > INT32_MAX) return -2;
    plan.ntiles = static_cast<int32_t>(ntiles_sub + nbr);
    plan.cmax = static_cast<int32_t>(cmax);
    plan.umax = static_cast<int32_t>(umax);
    int64_t dense_tiles = static_cast<int64_t>(nbr) * (nbr + 1) / 2;
    plan.advantage = (plan.ntiles < 0.5 * dense_tiles && nbr > 2) ? 1 : 0;
    plan.col_rows = std::move(cols);
    return 0;
}

void emit_schedule(const TilePlan& plan, int32_t* col_ids,
                   int32_t* col_blkrows, int32_t* u_a, int32_t* u_b,
                   int32_t* u_tgt) {
    int32_t nbr = plan.nbr, cmax = plan.cmax, umax = plan.umax;
    int32_t dummy = plan.ntiles;
    // Tile ids: diagonal tiles get id j; subdiagonal tiles column-major.
    std::vector<std::vector<int32_t>> ids(nbr);
    int32_t next_id = nbr;
    for (int32_t j = 0; j < nbr; ++j) {
        ids[j].resize(plan.col_rows[j].size());
        for (size_t p = 0; p < plan.col_rows[j].size(); ++p)
            ids[j][p] = next_id++;
    }
    std::fill(col_ids, col_ids + static_cast<int64_t>(nbr) * cmax, dummy);
    std::fill(col_blkrows, col_blkrows + static_cast<int64_t>(nbr) * cmax,
              nbr);
    std::fill(u_a, u_a + static_cast<int64_t>(nbr) * umax, 0);
    std::fill(u_b, u_b + static_cast<int64_t>(nbr) * umax, 0);
    std::fill(u_tgt, u_tgt + static_cast<int64_t>(nbr) * umax, dummy);
    for (int32_t j = 0; j < nbr; ++j) {
        const auto& rows = plan.col_rows[j];
        for (size_t p = 0; p < rows.size(); ++p) {
            col_ids[static_cast<int64_t>(j) * cmax + p] = ids[j][p];
            col_blkrows[static_cast<int64_t>(j) * cmax + p] = rows[p];
        }
        int32_t q = 0;
        for (size_t x = 0; x < rows.size(); ++x)
            for (size_t y = x; y < rows.size(); ++y) {
                int32_t a = rows[y], b = rows[x];  // a >= b
                int32_t tgt;
                if (a == b) {
                    tgt = a;  // diagonal tile
                } else {
                    const auto& tc = plan.col_rows[b];
                    size_t pos = std::lower_bound(tc.begin(), tc.end(), a) -
                                 tc.begin();
                    tgt = ids[b][pos];
                }
                int64_t off = static_cast<int64_t>(j) * umax + q;
                u_a[off] = static_cast<int32_t>(y);
                u_b[off] = static_cast<int32_t>(x);
                u_tgt[off] = tgt;
                ++q;
            }
    }
}

}  // namespace

extern "C" {

// RCM ordering of the K = A Aᵀ pattern. perm: length m (new -> old).
// Returns the half bandwidth of the permuted K pattern.
int32_t tlp_rcm(int32_t m, int32_t n, const int32_t* indptr,
                const int32_t* indices, int32_t* perm) {
    if (m <= 0) return 0;
    std::vector<std::vector<int32_t>> adj;
    build_k_adjacency(m, n, indptr, indices, adj);
    rcm(adj, m, perm);
    std::vector<int32_t> inv(m);
    for (int32_t k = 0; k < m; ++k) inv[perm[k]] = k;
    int32_t bw = 0;
    for (int32_t i = 0; i < m; ++i)
        for (int32_t j : adj[i])
            bw = std::max(bw, std::abs(inv[i] - inv[j]));
    return bw;
}

// Tile-granular symbolic factorization plan — handle protocol, so the
// adjacency + RCM + symbolic elimination run exactly once per setup:
//   tlp_tile_plan_new:  run the analysis; fill out_sizes = [nbr, ntiles,
//                       cmax, umax, advantage]; return an opaque handle
//                       (0 on bad input or int32 overflow of a dimension).
//   tlp_tile_plan_emit: copy perm (length m) and the padded schedule
//                       col_ids/col_blkrows (nbr*cmax) and u_a/u_b/u_tgt
//                       (nbr*umax) into caller-allocated buffers.
//   tlp_tile_plan_free: release the handle.
void* tlp_tile_plan_new(int32_t m, int32_t n, const int32_t* indptr,
                        const int32_t* indices, int32_t block,
                        int32_t* out_sizes) {
    if (m <= 0 || block <= 0) return nullptr;
    auto plan = new TilePlan();
    plan->m = m;
    plan->perm.resize(m);
    std::vector<std::vector<int32_t>> adj;
    build_k_adjacency(m, n, indptr, indices, adj);
    rcm(adj, m, plan->perm.data());
    if (tile_symbolic(adj, m, block, *plan) != 0) {
        delete plan;
        return nullptr;
    }
    out_sizes[0] = plan->nbr;
    out_sizes[1] = plan->ntiles;
    out_sizes[2] = plan->cmax;
    out_sizes[3] = plan->umax;
    out_sizes[4] = plan->advantage;
    return plan;
}

int32_t tlp_tile_plan_emit(void* handle, int32_t* perm, int32_t* col_ids,
                           int32_t* col_blkrows, int32_t* u_a, int32_t* u_b,
                           int32_t* u_tgt) {
    if (handle == nullptr) return -1;
    const auto* plan = static_cast<const TilePlan*>(handle);
    std::memcpy(perm, plan->perm.data(), sizeof(int32_t) * plan->m);
    emit_schedule(*plan, col_ids, col_blkrows, u_a, u_b, u_tgt);
    return 0;
}

void tlp_tile_plan_free(void* handle) {
    delete static_cast<TilePlan*>(handle);
}

}  // extern "C"
