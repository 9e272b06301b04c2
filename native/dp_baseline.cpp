// Sequential haplotype-threading DP — the native single-core baseline the
// device DP (ahsoka_tpu/thread/dp_jax.py) is benchmarked against.
//
// Implements the same cost model as the Python/JAX pipeline (coverage
// deviation + genotype conformity node costs; switch + affine transition
// costs over multiset states), in the sequential position-by-position style
// of the reference's WhatsHap HaploThreader call site
// (src/alignmentstoreadset.cpp:320,408).  Used by bench.py via ctypes.

#include <cstdint>
#include <cstring>
#include <vector>
#include <cmath>
#include <limits>

namespace {

// enumerate multisets of size k over m slots (lexicographic), as counts
void enumerate_states(int m, int k, std::vector<std::vector<int8_t>>& out) {
    std::vector<int> tuple(k, 0);
    while (true) {
        std::vector<int8_t> counts(m, 0);
        for (int i = 0; i < k; ++i) counts[tuple[i]]++;
        out.push_back(counts);
        int i = k - 1;
        while (i >= 0 && tuple[i] == m - 1) --i;
        if (i < 0) break;
        int v = tuple[i] + 1;
        for (int j = i; j < k; ++j) tuple[j] = v;
    }
}

}  // namespace

extern "C" {

// Runs the forward DP + backtrace over `P` positions; returns the number of
// DP "cells" processed (positions x states x transition states).
// Arrays: candidates[P*M] (int32, -1 pad), num_candidates[P], coverage[P*M]
// (f32), consensus[P*M] (i32), genotypes[P*A] (f32), out_states[P] (i32).
int64_t ahsoka_dp_baseline(
    const int32_t* candidates, const int32_t* num_candidates,
    const float* coverage, const int32_t* consensus, const float* genotypes,
    int64_t P, int64_t M, int64_t A, int32_t ploidy,
    float switch_cost, float affine_cost, float cov_w, float geno_w,
    int32_t* out_states) {
    if (P <= 0) return 0;
    const int k = ploidy;
    // full-width state enumeration shared by every position (states
    // referencing an empty candidate slot get +inf node cost), matching
    // thread/states.full_state_counts
    std::vector<std::vector<int8_t>> states;
    enumerate_states((int)M, k, states);
    // largest slot used by each state (tuples are sorted ascending)
    std::vector<int> max_slot(states.size(), 0);
    for (size_t s = 0; s < states.size(); ++s)
        for (int m = 0; m < M; ++m)
            if (states[s][m] > 0) max_slot[s] = m;

    const float INF = std::numeric_limits<float>::infinity();
    int64_t cells = 0;

    const float BIG = std::numeric_limits<float>::infinity();
    auto node_costs = [&](int64_t j, std::vector<float>& out) {
        int m = num_candidates[j];
        out.assign(states.size(), 0.f);
        for (size_t s = 0; s < states.size(); ++s) {
            if (max_slot[s] >= m) { out[s] = BIG; continue; }
            float cov_cost = 0.f;
            for (int c = 0; c < M; ++c)
                cov_cost += std::fabs(coverage[j * M + c] -
                                      (float)states[s][c] / k);
            std::vector<float> allele_counts(A, 0.f);
            for (int c = 0; c < m; ++c) {
                int a = consensus[j * M + c];
                if (a >= 0 && a < A) allele_counts[a] += states[s][c];
            }
            float geno_cost = 0.f;
            for (int a = 0; a < A; ++a)
                geno_cost += std::fabs(allele_counts[a] -
                                       genotypes[j * A + a]);
            out[s] = cov_w * cov_cost + geno_w * 0.5f * geno_cost;
        }
    };

    std::vector<float> cost, node, next_cost;
    std::vector<std::vector<int32_t>> backptr(P);
    node_costs(0, cost);

    for (int64_t j = 0; j + 1 < P; ++j) {
        node_costs(j + 1, node);
        next_cost.assign(states.size(), INF);
        backptr[j + 1].assign(states.size(), 0);
        // slot id match table: position-(j+1) slot q -> position-j slot
        std::vector<int> match(M, -1);
        for (int q = 0; q < M; ++q)
            for (int p = 0; p < M; ++p)
                if (candidates[(j + 1) * M + q] == candidates[j * M + p] &&
                    candidates[j * M + p] >= 0)
                    match[q] = p;
        for (size_t t = 0; t < states.size(); ++t) {
            // map state t's counts onto position-j slots
            std::vector<int8_t> mapped(M, 0);
            for (int q = 0; q < M; ++q)
                if (match[q] >= 0) mapped[match[q]] += states[t][q];
            float best = INF; int32_t best_s = 0;
            for (size_t s = 0; s < states.size(); ++s) {
                int inter = 0;
                for (int p = 0; p < M; ++p)
                    inter += std::min(states[s][p], mapped[p]);
                int switches = k - inter;
                float trans = switch_cost * switches +
                              (switches > 0 ? affine_cost : 0.f);
                float tot = cost[s] + trans;
                if (tot < best) { best = tot; best_s = (int32_t)s; }
            }
            next_cost[t] = best + node[t];
            backptr[j + 1][t] = best_s;
            cells += states.size();
        }
        cost = next_cost;
    }

    // backtrace
    int32_t s = 0; float best = INF;
    for (size_t t = 0; t < cost.size(); ++t)
        if (cost[t] < best) { best = cost[t]; s = (int32_t)t; }
    for (int64_t j = P - 1; j >= 0; --j) {
        out_states[j] = s;
        if (j > 0) s = backptr[j][s];
    }
    return cells;
}

}  // extern "C"
