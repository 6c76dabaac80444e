#!/usr/bin/env bash
# Host-side C++ sanitizer check (SURVEY.md §5.2: the reference has no
# sanitizer coverage for its unsafe native code; this build adds
# ASAN/UBSAN CI for the only native code it has — the host helpers).
#
# Usage: bash sublinear_tpu/native/check_sanitizers.sh
set -euo pipefail
cd "$(dirname "$0")"

g++ -O1 -g -fsanitize=address,undefined -fno-omit-frame-pointer \
    -shared -fPIC packer.cpp -o libsltnative_asan.so

cat > /tmp/slt_san_driver.cpp <<'EOF'
#include <cstdint>
#include <cstdio>
#include <vector>
#include <random>

extern "C" {
int64_t coo_to_csr(const int64_t*, const int64_t*, const double*, int64_t,
                   int64_t, int64_t*, int32_t*, double*);
int32_t greedy_coloring(const int64_t*, const int32_t*, const int64_t*,
                        const int32_t*, int64_t, int32_t*);
void dijkstra_multi_source(const int64_t*, const int32_t*, const double*,
                           int64_t, const int64_t*, const double*, int64_t,
                           double, double*, double*);
void row_positions(const int64_t*, int64_t, int64_t, int64_t*);
}

int main() {
    std::mt19937_64 rng(7);
    const int64_t n = 500, nnz = 5000;
    std::vector<int64_t> rows(nnz), cols(nnz);
    std::vector<double> vals(nnz);
    for (int64_t i = 0; i < nnz; ++i) {
        rows[i] = rng() % n;
        cols[i] = rng() % n;
        vals[i] = 1.0 + (double)(rng() % 100) / 50.0;
    }
    std::vector<int64_t> indptr(n + 1);
    std::vector<int32_t> indices(nnz);
    std::vector<double> data(nnz);
    int64_t out_n = coo_to_csr(rows.data(), cols.data(), vals.data(), nnz, n,
                               indptr.data(), indices.data(), data.data());
    std::printf("coo_to_csr: %lld entries\n", (long long)out_n);

    std::vector<int32_t> colors(n);
    int32_t nc = greedy_coloring(indptr.data(), indices.data(), indptr.data(),
                                 indices.data(), n, colors.data());
    std::printf("coloring: %d colors\n", nc);

    std::vector<int64_t> srcs = {0, 7};
    std::vector<double> sv = {1.0, 2.0};
    std::vector<double> dist(n), srcval(n);
    dijkstra_multi_source(indptr.data(), indices.data(), data.data(), n,
                          srcs.data(), sv.data(), 2, 1e30, dist.data(),
                          srcval.data());
    std::printf("dijkstra: dist[0]=%g\n", dist[0]);

    std::vector<int64_t> pos(out_n);
    row_positions(indptr.data(), n, out_n, pos.data());
    std::printf("sanitizer check OK\n");
    return 0;
}
EOF

g++ -O1 -g -fsanitize=address,undefined -fno-omit-frame-pointer \
    /tmp/slt_san_driver.cpp -o /tmp/slt_san_driver -L. -lsltnative_asan \
    -Wl,-rpath,"$(pwd)"
/tmp/slt_san_driver
rm -f libsltnative_asan.so /tmp/slt_san_driver /tmp/slt_san_driver.cpp
echo "ASAN/UBSAN: clean"
