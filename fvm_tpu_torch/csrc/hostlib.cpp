// Host-side setup loop of the greedy AMG: aggregation of an ELL row graph.
//
// The loop is O(n K) but a Python loop costs ~8 s per million rows, so the
// port compiles it with the host C++ compiler at first use
// (fvm_tpu_torch/hostlib.py) and calls it through ctypes.  It is the
// counterpart of the reference's C++ coarsening (CRMatrix.h:468
// createCoarsening) and must give the same aggregates, id for id, as the
// numpy loop linear/amg.py:aggregate_plain (seed an unaggregated row,
// absorb its unaggregated neighbours; singletons join a neighbour's
// aggregate; ids compressed in increasing order).

#include <cstdint>
#include <vector>

extern "C" {

// cols, mask: n x K row-major; agg: n entries, filled with compressed
// aggregate ids.  Returns the number of aggregates.
int64_t fvm_aggregate(int64_t n, int64_t K, const int64_t* cols,
                      const uint8_t* mask, int64_t* agg) {
  for (int64_t i = 0; i < n; ++i) agg[i] = -1;
  int64_t next_agg = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (agg[i] >= 0) continue;
    agg[i] = next_agg;
    const int64_t* ci = cols + i * K;
    const uint8_t* mi = mask + i * K;
    for (int64_t k = 0; k < K; ++k) {
      if (mi[k]) {
        const int64_t j = ci[k];
        if (agg[j] < 0) agg[j] = next_agg;
      }
    }
    ++next_agg;
  }
  // attach singleton aggregates to a neighbour, in row order
  std::vector<int64_t> sizes(next_agg, 0);
  for (int64_t i = 0; i < n; ++i) ++sizes[agg[i]];
  for (int64_t i = 0; i < n; ++i) {
    if (sizes[agg[i]] != 1) continue;
    const int64_t* ci = cols + i * K;
    const uint8_t* mi = mask + i * K;
    for (int64_t k = 0; k < K; ++k) {
      if (mi[k] && agg[ci[k]] != agg[i]) {
        --sizes[agg[i]];
        agg[i] = agg[ci[k]];
        ++sizes[agg[i]];
        break;
      }
    }
  }
  // compress the ids that are still used, in increasing order
  std::vector<int64_t> remap(next_agg, -1);
  int64_t nc = 0;
  for (int64_t a = 0; a < next_agg; ++a)
    if (sizes[a] > 0) remap[a] = nc++;
  for (int64_t i = 0; i < n; ++i) agg[i] = remap[agg[i]];
  return nc;
}

}  // extern "C"
