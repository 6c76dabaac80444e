// Host-side native helpers: triplet->CSR packing, ELL slot assignment,
// greedy graph coloring, and a priority-queue Dijkstra oracle.
//
// Replacement for the reference's host-side native layer
// (/root/reference/src/matrix/sparse.rs construction paths,
// /root/reference/src/ultra_fast.rs generate/pack helpers,
// /root/reference/src/bmssp.rs Dijkstra).  Device compute stays in
// JAX/XLA; this code only accelerates irregular host-side packing
// that NumPy handles poorly at scale.  Exposed via ctypes (see native.py);
// every entry point has a pure-NumPy fallback.
//
// Build: g++ -O3 -march=native -shared -fPIC packer.cpp -o libsltnative.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// Sort COO triplets by (row, col) and sum duplicates.
// Returns the deduplicated count; outputs written in place into out_* arrays
// (caller allocates nnz-sized buffers).
int64_t coo_to_csr(
    const int64_t* rows, const int64_t* cols, const double* vals, int64_t nnz,
    int64_t n_rows,
    int64_t* out_indptr,   // n_rows + 1
    int32_t* out_indices,  // >= nnz
    double* out_data       // >= nnz
) {
    std::vector<int64_t> order(nnz);
    for (int64_t i = 0; i < nnz; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        if (rows[a] != rows[b]) return rows[a] < rows[b];
        return cols[a] < cols[b];
    });

    std::memset(out_indptr, 0, sizeof(int64_t) * (n_rows + 1));
    int64_t out_n = 0;
    int64_t prev_r = -1, prev_c = -1;
    for (int64_t k = 0; k < nnz; ++k) {
        int64_t i = order[k];
        int64_t r = rows[i], c = cols[i];
        if (r == prev_r && c == prev_c) {
            out_data[out_n - 1] += vals[i];
        } else {
            out_indices[out_n] = (int32_t)c;
            out_data[out_n] = vals[i];
            out_indptr[r + 1] += 1;
            out_n += 1;
            prev_r = r;
            prev_c = c;
        }
    }
    for (int64_t r = 0; r < n_rows; ++r) out_indptr[r + 1] += out_indptr[r];
    return out_n;
}

// Greedy graph coloring over a symmetrized CSR pattern (for multicolor GS).
// Returns the number of colors. colors: out array of size n.
int32_t greedy_coloring(
    const int64_t* indptr, const int32_t* indices,
    const int64_t* t_indptr, const int32_t* t_indices,
    int64_t n, int32_t* colors
) {
    for (int64_t i = 0; i < n; ++i) colors[i] = -1;
    std::vector<int32_t> mark(n, -1);
    int32_t max_color = 0;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            int32_t j = indices[k];
            if (j != i && colors[j] >= 0) mark[colors[j]] = (int32_t)i;
        }
        for (int64_t k = t_indptr[i]; k < t_indptr[i + 1]; ++k) {
            int32_t j = t_indices[k];
            if (j != i && colors[j] >= 0) mark[colors[j]] = (int32_t)i;
        }
        int32_t c = 0;
        while (c < (int32_t)n && mark[c] == (int32_t)i) ++c;
        colors[i] = c;
        if (c + 1 > max_color) max_color = c + 1;
    }
    return max_color;
}

// Multi-source bounded Dijkstra over the matrix graph with edge cost
// 1/|a_ij| — the exact-priority-queue oracle for the device Bellman-Ford
// (reference: bmssp.rs:93-166).
// dist/srcval: out arrays of size n (dist pre-filled by caller is ignored).
void dijkstra_multi_source(
    const int64_t* indptr, const int32_t* indices, const double* data,
    int64_t n,
    const int64_t* sources, const double* source_vals, int64_t n_sources,
    double bound,
    double* dist, double* srcval
) {
    const double INF = 1e30;
    for (int64_t i = 0; i < n; ++i) { dist[i] = INF; srcval[i] = 0.0; }
    using Item = std::pair<double, int64_t>;
    std::priority_queue<Item, std::vector<Item>, std::greater<Item>> pq;
    for (int64_t s = 0; s < n_sources; ++s) {
        int64_t node = sources[s];
        dist[node] = 0.0;
        srcval[node] = source_vals[s];
        pq.push({0.0, node});
    }
    while (!pq.empty()) {
        auto [d, u] = pq.top();
        pq.pop();
        if (d > dist[u]) continue;
        for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
            int64_t v = indices[k];
            if (v == u) continue;
            double w = data[k];
            if (w == 0.0) continue;
            double cost = 1.0 / std::abs(w);
            double nd = d + cost;
            if (nd < dist[v] && nd <= bound) {
                dist[v] = nd;
                srcval[v] = srcval[u];
                pq.push({nd, v});
            }
        }
    }
}

// ELL slot assignment: positions of each CSR entry within its row.
void row_positions(const int64_t* indptr, int64_t n, int64_t nnz, int64_t* pos) {
    for (int64_t r = 0; r < n; ++r) {
        int64_t p = 0;
        for (int64_t k = indptr[r]; k < indptr[r + 1]; ++k) pos[k] = p++;
    }
}

// Reverse Cuthill-McKee ordering over the symmetrized pattern (indptr/indices
// = A, t_indptr/t_indices = A^T so asymmetric patterns work).  BFS from a
// minimum-degree node per component, neighbors visited in ascending-degree
// order, final order reversed.  Writes the permutation (perm[new] = old).
void rcm_ordering(
    const int64_t* indptr, const int32_t* indices,
    const int64_t* t_indptr, const int32_t* t_indices,
    int64_t n, int64_t* perm
) {
    std::vector<int64_t> degree(n);
    for (int64_t i = 0; i < n; ++i)
        degree[i] = (indptr[i + 1] - indptr[i]) + (t_indptr[i + 1] - t_indptr[i]);
    std::vector<char> visited(n, 0);
    std::vector<int64_t> order;
    order.reserve(n);
    std::vector<int64_t> nbrs;

    // process components from lowest-degree unvisited seeds
    std::vector<int64_t> seeds(n);
    for (int64_t i = 0; i < n; ++i) seeds[i] = i;
    std::sort(seeds.begin(), seeds.end(), [&](int64_t a, int64_t b) {
        return degree[a] < degree[b] || (degree[a] == degree[b] && a < b);
    });

    size_t head = 0;
    for (int64_t s : seeds) {
        if (visited[s]) continue;
        visited[s] = 1;
        order.push_back(s);
        while (head < order.size()) {
            int64_t u = order[head++];
            nbrs.clear();
            for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
                int64_t v = indices[k];
                if (v != u && !visited[v]) { visited[v] = 1; nbrs.push_back(v); }
            }
            for (int64_t k = t_indptr[u]; k < t_indptr[u + 1]; ++k) {
                int64_t v = t_indices[k];
                if (v != u && !visited[v]) { visited[v] = 1; nbrs.push_back(v); }
            }
            std::sort(nbrs.begin(), nbrs.end(), [&](int64_t a, int64_t b) {
                return degree[a] < degree[b] || (degree[a] == degree[b] && a < b);
            });
            for (int64_t v : nbrs) order.push_back(v);
        }
    }
    for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

}  // extern "C"
