// Host-side native compute for the data plane.
//
// Own copy of occlusions4d_tpu/native/host_ops.cpp: dataloader-side farthest
// point sampling and the exact 1-NN of the test-time labels and metrics, on
// the host (the device plane uses the CUDA kernels of csrc/ instead). Built
// with -O3 -march=native; bound via ctypes.
//
// Exposed C ABI:
//   o4d_fps      greedy farthest point sampling, O(n * n_out)
//   o4d_nn1      exact 1-NN distances+indices, blocked for cache locality
//   o4d_nn1_grid exact 1-NN via a uniform key grid (large-problem path);
//                bit-identical results to o4d_nn1 (same per-pair distance
//                expression, lexicographic (d, index) winner rule)
//   o4d_knn      exact kNN (small k) via per-query bounded insertion sort

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// Morton helper: spread the low 10 bits across every third bit.
inline uint32_t part1by2(uint32_t x) {
    x &= 0x3ffu;
    x = (x | (x << 16)) & 0x030000ffu;
    x = (x | (x << 8)) & 0x0300f00fu;
    x = (x | (x << 4)) & 0x030c30c3u;
    x = (x | (x << 2)) & 0x09249249u;
    return x;
}

// Plain O(n * n_out) greedy FPS (small-problem path; also the semantics
// oracle for the chunked variant below).
void fps_naive(const float* xyz, int64_t n, int64_t n_out, int64_t start_idx,
               int32_t* out_idx, float* scratch_min_d) {
    for (int64_t i = 0; i < n; i++) scratch_min_d[i] = FLT_MAX;
    int64_t cur = start_idx;
    out_idx[0] = (int32_t)cur;
    for (int64_t s = 1; s < n_out; s++) {
        const float cx = xyz[cur * 3 + 0];
        const float cy = xyz[cur * 3 + 1];
        const float cz = xyz[cur * 3 + 2];
        float best = -1.0f;
        int64_t best_i = 0;
        for (int64_t i = 0; i < n; i++) {
            const float dx = xyz[i * 3 + 0] - cx;
            const float dy = xyz[i * 3 + 1] - cy;
            const float dz = xyz[i * 3 + 2] - cz;
            const float d = dx * dx + dy * dy + dz * dz;
            if (d < scratch_min_d[i]) scratch_min_d[i] = d;
            if (scratch_min_d[i] > best) { best = scratch_min_d[i]; best_i = i; }
        }
        cur = best_i;
        out_idx[s] = (int32_t)cur;
    }
}

}  // namespace

extern "C" {

// Farthest point sampling over (n, 3) float32 coordinates.
// out_idx must hold n_out int32. Selection starts at start_idx (deterministic when 0).
//
// Large problems use a QuickFPS-style chunked algorithm: points are sorted
// along a Morton curve into compact chunks with bounding boxes; each chunk
// tracks the (max, argmax) of its running min-distance field, and a chunk is
// skipped for an iteration when the squared distance from the new pick to its
// bbox is >= its stored max (then d(i, pick) >= lb >= max >= min_d[i] for
// every member, so no update can happen and the stored max/argmax stay
// valid). Chunks are grouped S-to-a-superchunk with union bboxes and the
// running max of their children's maxima; a superchunk whose bbox lower
// bound is >= that running max skips all 16 children with one test (the
// child bound is >= the super bound, so each child's own skip condition
// already held — the set of scanned chunks, and hence every float, is
// bit-identical to the flat scan). This turns the two O(n_out * nchunks)
// serial loops (per-chunk bound tests + global argmax) into
// O(n_out * nsupers) ones. The greedy pick sequence is exact; only the scan
// order used to break exact floating-point argmax ties differs from the
// naive loop. The dataloader's 14336-of-~170k input FPS drops from ~4 s to
// tens of ms.
void o4d_fps(const float* xyz, int64_t n, int64_t n_out, int64_t start_idx,
             int32_t* out_idx, float* scratch_min_d) {
    if (n <= 0 || n_out <= 0) return;
    if (n < 16384 || n_out < 256) {
        fps_naive(xyz, n, n_out, start_idx, out_idx, scratch_min_d);
        return;
    }

    // Morton-sort point order (indices only).
    float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int64_t i = 0; i < n; i++) {
        for (int c = 0; c < 3; c++) {
            const float v = xyz[i * 3 + c];
            if (v < lo[c]) lo[c] = v;
            if (v > hi[c]) hi[c] = v;
        }
    }
    float inv[3];
    for (int c = 0; c < 3; c++) {
        const float span = hi[c] - lo[c];
        inv[c] = span > 1e-12f ? 1023.0f / span : 0.0f;
    }
    std::vector<uint64_t> order(n);  // (morton << 32) | original index.
    for (int64_t i = 0; i < n; i++) {
        const uint32_t qx = (uint32_t)((xyz[i * 3 + 0] - lo[0]) * inv[0]);
        const uint32_t qy = (uint32_t)((xyz[i * 3 + 1] - lo[1]) * inv[1]);
        const uint32_t qz = (uint32_t)((xyz[i * 3 + 2] - lo[2]) * inv[2]);
        const uint64_t code = part1by2(qx) | (part1by2(qy) << 1)
                              | (part1by2(qz) << 2);
        order[i] = (code << 32) | (uint64_t)(uint32_t)i;
    }
    std::sort(order.begin(), order.end());

    // SoA in sorted order + per-chunk bboxes.
    const int64_t C = 256;
    const int64_t nchunks = (n + C - 1) / C;
    std::vector<float> px(n), py(n), pz(n), min_d(n, FLT_MAX);
    std::vector<int32_t> orig(n);
    std::vector<float> clo(nchunks * 3), chi(nchunks * 3);
    std::vector<float> cmax(nchunks, FLT_MAX);
    std::vector<int32_t> cargmax(nchunks, 0);
    int64_t cur_sorted = 0;
    for (int64_t i = 0; i < n; i++) {
        const int32_t oi = (int32_t)(order[i] & 0xffffffffu);
        px[i] = xyz[oi * 3 + 0];
        py[i] = xyz[oi * 3 + 1];
        pz[i] = xyz[oi * 3 + 2];
        orig[i] = oi;
        if (oi == (int32_t)start_idx) cur_sorted = i;
    }
    for (int64_t c = 0; c < nchunks; c++) {
        const int64_t i0 = c * C, i1 = std::min(n, i0 + C);
        float l0 = FLT_MAX, l1 = FLT_MAX, l2 = FLT_MAX;
        float h0 = -FLT_MAX, h1 = -FLT_MAX, h2 = -FLT_MAX;
        for (int64_t i = i0; i < i1; i++) {
            l0 = std::min(l0, px[i]); h0 = std::max(h0, px[i]);
            l1 = std::min(l1, py[i]); h1 = std::max(h1, py[i]);
            l2 = std::min(l2, pz[i]); h2 = std::max(h2, pz[i]);
        }
        clo[c * 3 + 0] = l0; clo[c * 3 + 1] = l1; clo[c * 3 + 2] = l2;
        chi[c * 3 + 0] = h0; chi[c * 3 + 1] = h1; chi[c * 3 + 2] = h2;
        cargmax[c] = (int32_t)i0;
    }

    // Superchunk level: union bboxes + running max over child maxima.
    const int64_t S = 32;
    const int64_t nsup = (nchunks + S - 1) / S;
    std::vector<float> slo(nsup * 3), shi(nsup * 3);
    std::vector<float> smax(nsup, FLT_MAX);
    std::vector<int32_t> schild(nsup);
    for (int64_t u = 0; u < nsup; u++) {
        const int64_t c0 = u * S, c1 = std::min(nchunks, c0 + S);
        for (int d = 0; d < 3; d++) {
            float l = FLT_MAX, h = -FLT_MAX;
            for (int64_t c = c0; c < c1; c++) {
                l = std::min(l, clo[c * 3 + d]);
                h = std::max(h, chi[c * 3 + d]);
            }
            slo[u * 3 + d] = l;
            shi[u * 3 + d] = h;
        }
        schild[u] = (int32_t)c0;
    }

    out_idx[0] = (int32_t)start_idx;
    for (int64_t s = 1; s < n_out; s++) {
        const float cx = px[cur_sorted];
        const float cy = py[cur_sorted];
        const float cz = pz[cur_sorted];
        for (int64_t u = 0; u < nsup; u++) {
            const float sx = std::max({slo[u * 3 + 0] - cx, cx - shi[u * 3 + 0], 0.0f});
            const float sy = std::max({slo[u * 3 + 1] - cy, cy - shi[u * 3 + 1], 0.0f});
            const float sz = std::max({slo[u * 3 + 2] - cz, cz - shi[u * 3 + 2], 0.0f});
            // Super bound <= every child bound: skipping here is exactly the
            // per-child skip firing for all 16 children.
            if (sx * sx + sy * sy + sz * sz >= smax[u]) continue;
            const int64_t c0 = u * S, c1 = std::min(nchunks, c0 + S);
            bool touched = false;
            for (int64_t c = c0; c < c1; c++) {
                const float gx = std::max({clo[c * 3 + 0] - cx, cx - chi[c * 3 + 0], 0.0f});
                const float gy = std::max({clo[c * 3 + 1] - cy, cy - chi[c * 3 + 1], 0.0f});
                const float gz = std::max({clo[c * 3 + 2] - cz, cz - chi[c * 3 + 2], 0.0f});
                const float lb2 = gx * gx + gy * gy + gz * gz;
                if (lb2 >= cmax[c]) continue;  // no member's min_d can change.
                touched = true;
                const int64_t i0 = c * C, i1 = std::min(n, i0 + C);
                // Pass 1 (SIMD): distance + min-update + max-reduce. The
                // running (max, argmax) pair of the old single pass carries a
                // scalar dependence that blocks vectorization; a value-only
                // max reduction vectorizes, and a short second scan recovers
                // the FIRST index attaining it - the same tie-break the
                // scalar `nd > m` update produced.
                float m = -1.0f;
                #pragma omp simd reduction(max: m)
                for (int64_t i = i0; i < i1; i++) {
                    const float dx = px[i] - cx;
                    const float dy = py[i] - cy;
                    const float dz = pz[i] - cz;
                    const float d = dx * dx + dy * dy + dz * dz;
                    const float nd = d < min_d[i] ? d : min_d[i];
                    min_d[i] = nd;
                    m = nd > m ? nd : m;
                }
                int64_t mi = i0;
                for (int64_t i = i0; i < i1; i++)
                    if (min_d[i] == m) { mi = i; break; }
                cmax[c] = m;
                cargmax[c] = (int32_t)mi;
            }
            if (touched || smax[u] == FLT_MAX) {
                // Recompute the running (max, first-argmax) over the children
                // (also resolves the FLT_MAX sentinel once real maxima exist).
                float m = -1.0f;
                int64_t mc = c0;
                for (int64_t c = c0; c < c1; c++) {
                    if (cmax[c] > m) { m = cmax[c]; mc = c; }
                }
                smax[u] = m;
                schild[u] = (int32_t)mc;
            }
        }
        float best = -1.0f;
        int64_t best_u = 0;
        for (int64_t u = 0; u < nsup; u++) {
            if (smax[u] > best) { best = smax[u]; best_u = u; }
        }
        cur_sorted = cargmax[schild[best_u]];
        out_idx[s] = orig[cur_sorted];
    }
}

// Exact 1-NN: for each of n queries, Euclidean distance (and index) of the nearest
// of m keys. Blocked over keys for cache locality.
void o4d_nn1(const float* query, int64_t n, const float* keys, int64_t m,
             float* out_dist, int32_t* out_idx) {
    for (int64_t i = 0; i < n; i++) { out_dist[i] = FLT_MAX; out_idx[i] = 0; }
    const int64_t BLOCK = 2048;
    for (int64_t k0 = 0; k0 < m; k0 += BLOCK) {
        const int64_t k1 = (k0 + BLOCK < m) ? k0 + BLOCK : m;
        for (int64_t i = 0; i < n; i++) {
            const float qx = query[i * 3 + 0];
            const float qy = query[i * 3 + 1];
            const float qz = query[i * 3 + 2];
            float best = out_dist[i];
            int32_t best_j = out_idx[i];
            for (int64_t j = k0; j < k1; j++) {
                const float dx = keys[j * 3 + 0] - qx;
                const float dy = keys[j * 3 + 1] - qy;
                const float dz = keys[j * 3 + 2] - qz;
                const float d = dx * dx + dy * dy + dz * dz;
                if (d < best) { best = d; best_j = (int32_t)j; }
            }
            out_dist[i] = best;
            out_idx[i] = best_j;
        }
    }
    for (int64_t i = 0; i < n; i++) out_dist[i] = sqrtf(out_dist[i]);
}

// Exact 1-NN via a two-level uniform grid over the keys: counting-sort keys
// into fine cells (~4 keys/cell) and 8x-coarser cells, then per query expand
// Chebyshev cell rings until the ring's distance lower bound strictly exceeds
// the current best. Queries probe fine rings 0-2 first; if those are empty
// (the query sits in empty space — e.g. a dense eval grid point far from the
// scene surface) the search restarts self-contained at the coarse level,
// whose shells cover 512x the volume per cell, sidestepping the classic
// empty-shell blowup (measured 135 s -> sub-second on a scene-shaped
// 132k x 500k problem). Guarantees vs the brute-force o4d_nn1:
//   * identical distances: the same dx*dx+dy*dy+dz*dz expression compiled in
//     the same translation unit evaluates each (query, key) pair to the same
//     float regardless of visit order;
//   * identical winners incl. ties: selection is the lexicographic minimum of
//     (d, key index), which is visit-order independent and equals the brute
//     force's "first strict improvement in index order" rule;
//   * no missed keys: at either level, ring r's bound uses
//     (r - 1 - kSlackCells) * cell_width_min, where the slack rigorously
//     dominates the float error of cell binning (<= dims * 2^-23 ~ 3e-5
//     cells), and the loop scans on equality so an equal-distance lower-index
//     key can never be pruned. Each level's search is self-contained exact;
//     the fine probe only decides which level answers. Queries outside the
//     key bbox clamp to the boundary cell; distances only grow, so the bound
//     stays a valid lower bound and max_r still covers every cell.
void o4d_nn1_grid(const float* query, int64_t n, const float* keys, int64_t m,
                  float* out_dist, int32_t* out_idx) {
    // Key bounding box.
    float lo[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    float hi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int64_t j = 0; j < m; j++) {
        for (int a = 0; a < 3; a++) {
            const float v = keys[j * 3 + a];
            if (v < lo[a]) lo[a] = v;
            if (v > hi[a]) hi[a] = v;
        }
    }
    // Cubic cell size targeting ~4 keys per cell; degenerate extents get one
    // cell along their axis.
    double vol = 1.0;
    for (int a = 0; a < 3; a++)
        vol *= std::max((double)hi[a] - lo[a], 1e-9);
    double h = std::cbrt(vol * 4.0 / (double)std::max<int64_t>(m, 1));
    int64_t dims[3];
    for (;;) {
        int64_t total = 1;
        for (int a = 0; a < 3; a++) {
            dims[a] = std::max<int64_t>(
                1, std::min<int64_t>(1024, (int64_t)std::ceil(
                       ((double)hi[a] - lo[a]) / h)));
            total *= dims[a];
        }
        if (total <= (int64_t)1 << 21) break;
        h *= 1.5;  // Cap the cell table at ~2M entries.
    }
    float cw[3], inv_cw[3];
    float cw_min = FLT_MAX;
    for (int a = 0; a < 3; a++) {
        cw[a] = std::max(((float)hi[a] - lo[a]) / (float)dims[a], 1e-9f);
        inv_cw[a] = 1.0f / cw[a];
        if (cw[a] < cw_min) cw_min = cw[a];
    }
    const int64_t n_cells = dims[0] * dims[1] * dims[2];
    const int64_t sy = dims[2], sx = dims[1] * dims[2];

    auto cell_coord = [&](const float* p, int64_t* c) {
        for (int a = 0; a < 3; a++) {
            int64_t v = (int64_t)((p[a] - lo[a]) * inv_cw[a]);
            c[a] = v < 0 ? 0 : (v >= dims[a] ? dims[a] - 1 : v);
        }
    };

    // Coarse level: 8 fine cells per axis (512x the volume).
    const int64_t kShift = 3;
    int64_t dims_c[3];
    for (int a = 0; a < 3; a++) dims_c[a] = (dims[a] + 7) >> kShift;
    const int64_t n_cells_c = dims_c[0] * dims_c[1] * dims_c[2];
    const int64_t sy_c = dims_c[2], sx_c = dims_c[1] * dims_c[2];
    const float cw_c_min = cw_min * (float)(1 << kShift);

    // Counting sort of key indices by cell, at both levels (fill in index
    // order -> each cell's bucket is ascending in the original key index).
    std::vector<int32_t> counts(n_cells + 1, 0);
    std::vector<int32_t> counts_c(n_cells_c + 1, 0);
    std::vector<int64_t> key_cell(m), key_cell_c(m);
    for (int64_t j = 0; j < m; j++) {
        int64_t c[3];
        cell_coord(keys + j * 3, c);
        key_cell[j] = c[0] * sx + c[1] * sy + c[2];
        key_cell_c[j] = (c[0] >> kShift) * sx_c + (c[1] >> kShift) * sy_c
                        + (c[2] >> kShift);
        counts[key_cell[j] + 1]++;
        counts_c[key_cell_c[j] + 1]++;
    }
    for (int64_t c = 0; c < n_cells; c++) counts[c + 1] += counts[c];
    for (int64_t c = 0; c < n_cells_c; c++) counts_c[c + 1] += counts_c[c];
    std::vector<int32_t> order(m), order_c(m);
    {
        std::vector<int32_t> cursor(counts.begin(), counts.end() - 1);
        std::vector<int32_t> cursor_c(counts_c.begin(), counts_c.end() - 1);
        for (int64_t j = 0; j < m; j++) {
            order[cursor[key_cell[j]]++] = (int32_t)j;
            order_c[cursor_c[key_cell_c[j]]++] = (int32_t)j;
        }
    }

    const double kSlackCells = 1e-3;  // >> float binning error (~3e-5 cells).

    // Exact ring scan at one level over rings [r_lo, min(r_hi, grid edge)],
    // folding candidates into the running lexicographic (d, index) minimum.
    // Scanning rings [0, k] then continuing with [k+1, ...] on the same
    // accumulator is identical to one full scan (min over a union).
    auto ring_search = [&](const float* q, const int64_t* cq,
                           const int64_t* dm, int64_t stride_x,
                           int64_t stride_y, const int32_t* cts,
                           const int32_t* ord, float width_min, int64_t r_lo,
                           int64_t r_hi, float* best, int32_t* best_j) {
        int64_t max_r = 0;
        for (int a = 0; a < 3; a++) {
            max_r = std::max(max_r, cq[a]);
            max_r = std::max(max_r, dm[a] - 1 - cq[a]);
        }
        max_r = std::min(max_r, r_hi);
        const float qx = q[0], qy = q[1], qz = q[2];
        for (int64_t r = r_lo; r <= max_r; r++) {
            if (r >= 2) {
                const double lb = ((double)r - 1.0 - kSlackCells)
                                  * (double)width_min;
                if (lb * lb > (double)*best) break;  // scan-on-equal: '>'.
            }
            const int64_t x0 = std::max<int64_t>(0, cq[0] - r);
            const int64_t x1 = std::min<int64_t>(dm[0] - 1, cq[0] + r);
            const int64_t y0 = std::max<int64_t>(0, cq[1] - r);
            const int64_t y1 = std::min<int64_t>(dm[1] - 1, cq[1] + r);
            const int64_t z0 = std::max<int64_t>(0, cq[2] - r);
            const int64_t z1 = std::min<int64_t>(dm[2] - 1, cq[2] + r);
            for (int64_t x = x0; x <= x1; x++) {
                const bool x_face = (x == cq[0] - r) || (x == cq[0] + r);
                for (int64_t y = y0; y <= y1; y++) {
                    const bool y_face = (y == cq[1] - r) || (y == cq[1] + r);
                    for (int64_t z = z0; z <= z1; z++) {
                        // Shell only: skip cells already scanned at ring < r.
                        if (!x_face && !y_face
                            && !((z == cq[2] - r) || (z == cq[2] + r)))
                            continue;
                        const int64_t c = x * stride_x + y * stride_y + z;
                        for (int32_t t = cts[c]; t < cts[c + 1]; t++) {
                            const int32_t j = ord[t];
                            const float dx = keys[j * 3 + 0] - qx;
                            const float dy = keys[j * 3 + 1] - qy;
                            const float dz = keys[j * 3 + 2] - qz;
                            const float d = dx * dx + dy * dy + dz * dz;
                            if (d < *best || (d == *best && j < *best_j)) {
                                *best = d;
                                *best_j = j;
                            }
                        }
                    }
                }
            }
        }
    };

    // Stay at fine granularity only while the remaining ring span is small;
    // past this, coarse shells (64x fewer cells per shell) win even though
    // each one rescans ~512 fine cells' keys.
    const int64_t kFineMaxRings = 16;

    for (int64_t i = 0; i < n; i++) {
        int64_t cq[3];
        cell_coord(query + i * 3, cq);
        float best = FLT_MAX;
        int32_t best_j = 0;
        // Fine probe: rings 0-2, kept as the running minimum.
        ring_search(query + i * 3, cq, dims, sx, sy, counts.data(),
                    order.data(), cw_min, 0, 2, &best, &best_j);
        // Estimated remaining span at fine granularity. A probe hit with a
        // LARGE distance (a query far outside the key bbox, clamped onto a
        // populated boundary cell) must route coarse too, or it scans
        // O((d/cw)^3) near-empty fine shells.
        const double span = (best < FLT_MAX)
            ? std::sqrt((double)best) / (double)cw_min + 2.0
            : (double)INT64_MAX;
        if (span <= (double)kFineMaxRings) {
            // Continue the fine scan from ring 3 on the same accumulator
            // (identical to one full fine search).
            ring_search(query + i * 3, cq, dims, sx, sy, counts.data(),
                        order.data(), cw_min, 3, INT64_MAX, &best, &best_j);
        } else {
            // Self-contained exact coarse search (the probe result only
            // routed; the coarse scan revisits those keys among others).
            best = FLT_MAX;
            best_j = 0;
            int64_t cq_c[3] = {cq[0] >> kShift, cq[1] >> kShift,
                               cq[2] >> kShift};
            ring_search(query + i * 3, cq_c, dims_c, sx_c, sy_c,
                        counts_c.data(), order_c.data(), cw_c_min, 0,
                        INT64_MAX, &best, &best_j);
        }
        out_dist[i] = sqrtf(best);
        out_idx[i] = best_j;
    }
}

// Exact kNN for small k (<= 64): bounded insertion into a per-query sorted list.
// out_dist/out_idx are (n, k), ascending by distance, ties toward lower index.
void o4d_knn(const float* query, int64_t n, const float* keys, int64_t m,
             int64_t k, float* out_dist, int32_t* out_idx) {
    for (int64_t i = 0; i < n; i++) {
        float* dst_d = out_dist + i * k;
        int32_t* dst_i = out_idx + i * k;
        for (int64_t t = 0; t < k; t++) { dst_d[t] = FLT_MAX; dst_i[t] = 0; }
        const float qx = query[i * 3 + 0];
        const float qy = query[i * 3 + 1];
        const float qz = query[i * 3 + 2];
        for (int64_t j = 0; j < m; j++) {
            const float dx = keys[j * 3 + 0] - qx;
            const float dy = keys[j * 3 + 1] - qy;
            const float dz = keys[j * 3 + 2] - qz;
            const float d = dx * dx + dy * dy + dz * dz;
            if (d >= dst_d[k - 1]) continue;
            int64_t t = k - 1;
            while (t > 0 && dst_d[t - 1] > d) {
                dst_d[t] = dst_d[t - 1];
                dst_i[t] = dst_i[t - 1];
                t--;
            }
            dst_d[t] = d;
            dst_i[t] = (int32_t)j;
        }
        for (int64_t t = 0; t < k; t++) dst_d[t] = sqrtf(dst_d[t]);
    }
}

}  // extern "C"
