// Host-side event-stream scan kernels.
//
// Native (C++) implementations of the sequential, data-dependent algorithms
// that the reference JIT-compiles with Numba (ref: utils/events.py:72-218):
//   * successor-graph construction: one O(N) reverse scan assigning each
//     event the index of the next event at the same pixel;
//   * count-based event accumulation (polarity-summed groups of n);
//   * k-hop successor gather with per-query hop counts.
//
// Exposed with a plain C ABI for ctypes. All buffers are caller-allocated
// numpy arrays; no memory is owned here.

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// events_xy: int64 [N] flattened pixel ids (y*w+x or compact coord ids).
// Outputs (caller-allocated, length N): successor_idx (int64),
// num_successors (int32). latest/first (length num_pixels, int64) receive the
// first/last event index per pixel. Returns 0 on success.
int compute_successor_flat(const int64_t* events_xy, int64_t num_events,
                           int64_t num_pixels, int64_t* successor_idx,
                           int32_t* num_successors, int64_t* latest_seen,
                           int64_t* first_seen) {
  for (int64_t i = 0; i < num_pixels; ++i) {
    latest_seen[i] = -1;
    first_seen[i] = -1;
  }
  for (int64_t i = num_events - 1; i >= 0; --i) {
    const int64_t x = events_xy[i];
    if (x < 0 || x >= num_pixels) return 1;
    if (latest_seen[x] != -1) {
      successor_idx[i] = latest_seen[x];
      num_successors[i] = num_successors[latest_seen[x]] + 1;
    } else {
      successor_idx[i] = i;  // no successor: self index (ref: events.py:111)
      num_successors[i] = 0;
    }
    latest_seen[x] = i;
    if (first_seen[x] == -1) first_seen[x] = i;
  }
  return 0;
}

// Count-based accumulation (ref: utils/events.py:123-171, flat_xy variant).
// events: int64 [N,3] rows (xy, t, p). out: int64 [N,3]. Returns the number
// of output events written, or -1 on error.
int64_t accumulate_events_flat(const int64_t* events, int64_t num_events,
                               int64_t num_pixels, int64_t n,
                               int64_t* out_events) {
  std::vector<int32_t> running_seen(num_pixels, -1);
  std::vector<int64_t> running_pol(num_pixels, 0);
  int64_t num_out = 0;
  for (int64_t i = 0; i < num_events; ++i) {
    const int64_t x = events[i * 3 + 0];
    const int64_t t = events[i * 3 + 1];
    const int64_t p = events[i * 3 + 2];
    if (x < 0 || x >= num_pixels) return -1;
    if (running_seen[x] == -1) running_seen[x] = static_cast<int32_t>(n - 1);
    if (running_seen[x] == n - 1) {
      running_pol[x] += p;
      out_events[num_out * 3 + 0] = x;
      out_events[num_out * 3 + 1] = t;
      out_events[num_out * 3 + 2] = running_pol[x];
      running_pol[x] = 0;
      running_seen[x] = 0;
      ++num_out;
    } else {
      running_pol[x] += p;
      ++running_seen[x];
    }
  }
  return num_out;
}

// Timestamp-grid accumulation (ref: utils/events.py:174-218, flat ids).
// events: int64 [N,3] rows (xy, t, p), time-sorted. sampled: float64 [S]
// interval boundaries (already subsampled by the caller). Per interval
// [t0, t1): one aggregated row (x, t1, sum p) per ACTIVE pixel (ascending
// x), and one row (x, t0, t1) per INACTIVE pixel into out_zero. Caller
// allocates both outputs at capacity (S-1)*num_pixels rows. out_counts[0]
// and out_counts[1] receive the row counts. Returns 0 on success.
int accumulate_events_at_time_flat(const int64_t* events, int64_t num_events,
                                   int64_t num_pixels, const double* sampled,
                                   int64_t num_sampled, int64_t* out_events,
                                   int64_t* out_zero, int64_t* out_counts) {
  std::vector<int64_t> accum(num_pixels);
  int64_t n_ev = 0, n_zero = 0;
  int64_t lo = 0;
  // searchsorted-left of (sampled[0] - 1e-6) over the time column
  while (lo < num_events &&
         static_cast<double>(events[lo * 3 + 1]) < sampled[0] - 1e-6) {
    ++lo;
  }
  for (int64_t s = 0; s + 1 < num_sampled; ++s) {
    const double t1_cut = sampled[s + 1] - 1e-6;
    int64_t hi = lo;
    while (hi < num_events &&
           static_cast<double>(events[hi * 3 + 1]) < t1_cut) {
      ++hi;
    }
    std::memset(accum.data(), 0, sizeof(int64_t) * num_pixels);
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t x = events[i * 3 + 0];
      if (x < 0 || x >= num_pixels) return 1;
      accum[x] += events[i * 3 + 2];
    }
    const int64_t t0 = static_cast<int64_t>(sampled[s]);
    const int64_t t1 = static_cast<int64_t>(sampled[s + 1]);
    for (int64_t x = 0; x < num_pixels; ++x) {
      if (accum[x] != 0) {
        out_events[n_ev * 3 + 0] = x;
        out_events[n_ev * 3 + 1] = t1;
        out_events[n_ev * 3 + 2] = accum[x];
        ++n_ev;
      } else {
        out_zero[n_zero * 3 + 0] = x;
        out_zero[n_zero * 3 + 1] = t0;
        out_zero[n_zero * 3 + 2] = t1;
        ++n_zero;
      }
    }
    lo = hi;
  }
  out_counts[0] = n_ev;
  out_counts[1] = n_zero;
  return 0;
}

// K-hop successor gather (ref: utils/events.py:221-257).
// query_idx/query_hops: int64 [Q]; successor_map/polarities: int64 [N].
// Outputs int64 [Q]: out_idx, out_neg, out_pos.
int gather_successor(const int64_t* query_idx, const int64_t* query_hops,
                     int64_t num_queries, const int64_t* successor_map,
                     const int64_t* polarities, int64_t map_len,
                     int64_t* out_idx, int64_t* out_neg, int64_t* out_pos) {
  for (int64_t q = 0; q < num_queries; ++q) {
    int64_t cur = query_idx[q];
    int64_t pos = 0, neg = 0;
    bool invalid = false;
    const int64_t hops = query_hops[q];
    for (int64_t h = 0; h <= hops; ++h) {
      if (cur < 0 || cur >= map_len) {
        invalid = true;
        break;
      }
      const int64_t nxt = successor_map[cur];
      if (nxt < 0 || nxt >= map_len) {
        invalid = true;
        break;
      }
      const int64_t p = polarities[nxt];
      if (p > 0) pos += p; else neg += p;
      cur = nxt;
    }
    if (invalid) {
      out_idx[q] = -1;
      out_neg[q] = 0;
      out_pos[q] = 0;
    } else {
      out_idx[q] = cur;
      out_neg[q] = neg;
      out_pos[q] = pos;
    }
  }
  return 0;
}

}  // extern "C"
