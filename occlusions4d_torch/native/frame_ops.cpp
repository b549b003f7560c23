// Fused GREATER per-frame decode (data-plane hot path).
//
// Own copy of occlusions4d_tpu/native/frame_ops.cpp. The numpy chain pays
// this cost per frame (preflat hue clustering, RGB-D unprojection,
// cuboid+floor filtering); this translation unit fuses all three into one
// pass over pixels.
//
// Bit-exactness contract: every arithmetic step mirrors the numpy chain in
// occlusions4d_torch/data/greater.py (same scalar expressions, same
// parenthesization, same promotion to float64 where numpy promotes). This
// file is therefore compiled with -ffp-contract=off (see native/__init__.py)
// so the compiler cannot fuse a*b+c into fma and change the rounding; tests
// assert byte-identical outputs vs the numpy fallback.

#include <cfenv>
#include <cmath>
#include <cstdint>

namespace {

// matplotlib-semantics hue [0,1) and saturation of one pixel, mirroring
// greater.py::_rgb_to_hue_sat (works on any channel scale).
inline void hue_sat(float r, float g, float b, float* h_out, float* s_out) {
    const float mx = r > g ? (r > b ? r : b) : (g > b ? g : b);
    const float mn = r < g ? (r < b ? r : b) : (g < b ? g : b);
    const float delta = mx - mn;
    const float safe = delta > 0.0f ? delta : 1.0f;
    float h;
    if (mx == r) {
        h = (g - b) / safe;
    } else if (mx == g) {
        h = 2.0f + (b - r) / safe;
    } else {
        h = 4.0f + (r - g) / safe;
    }
    if (delta > 0.0f) {
        // numpy: (h / 6.0) % 1.0 — fmod with the sign corrected into [0, 1).
        float m = fmodf(h / 6.0f, 1.0f);
        if (m < 0.0f) m += 1.0f;
        h = m;
    } else {
        h = 0.0f;
    }
    *h_out = h;
    *s_out = mx > 0.0f ? delta / mx : 0.0f;
}

}  // namespace

extern "C" {

// Fused frame decode. Row-major (H, W, 3) rgb + preflat, (H, W) depth (already
// scaled to metric units). iK is the inverse intrinsics (3, 3); iRT the top 3
// rows of the inverse extrinsics (3, 4). cuboid = {x0, x1, y0, y1, z0, z1};
// use_floor applies the GREATER curving-floor cut z > (max(|x|,|y|)-4.5)/3.5.
// clusters are the preflat hue cluster centers (float64: numpy promotes
// f32 - int64 to f64 for the argmin). Valid (depth > 0) points that pass the
// filters are written to out as (x, y, z, instance_id, R, G, B) rows in pixel
// row-major order; *n_valid_out gets the depth-valid count (pre-filter).
// Returns the number of rows written.
int64_t o4d_greater_frame(const float* rgb, const float* flat,
                          const float* depth, int64_t H, int64_t W,
                          const float* iK, const float* iRT,
                          const float* cuboid, int use_floor,
                          const double* clusters, int64_t n_clusters,
                          float sat_thresh, float* out,
                          int64_t* n_valid_out) {
    const float iK00 = iK[0], iK01 = iK[1], iK02 = iK[2];
    const float iK10 = iK[3], iK11 = iK[4], iK12 = iK[5];
    const float iK20 = iK[6], iK21 = iK[7], iK22 = iK[8];

    int64_t n_valid = 0;
    int64_t n_out = 0;
    for (int64_t yy = 0; yy < H; yy++) {
        for (int64_t xx = 0; xx < W; xx++) {
            const int64_t p = yy * W + xx;
            const float z = depth[p];
            if (!(z > 0.0f)) continue;
            n_valid++;

            const float xf = (float)xx;
            const float yf = (float)yy;
            // Camera ray, mirroring greater.py: ((iK*c0)*x + (iK*c1)*y) + iK*c2.
            const float dx = (iK00 * xf + iK01 * yf) + iK02;
            const float dy = (iK10 * xf + iK11 * yf) + iK12;
            const float dz = (iK20 * xf + iK21 * yf) + iK22;
            const float cx = dx * z;
            const float cy = dy * z;
            const float cz = dz * z;
            // World point: (((r0*cx + r1*cy) + r2*cz) + t).
            const float wx = ((iRT[0] * cx + iRT[1] * cy) + iRT[2] * cz) + iRT[3];
            const float wy = ((iRT[4] * cx + iRT[5] * cy) + iRT[6] * cz) + iRT[7];
            const float wz = ((iRT[8] * cx + iRT[9] * cy) + iRT[10] * cz) + iRT[11];

            if (!(cuboid[0] <= wx && wx <= cuboid[1]
                  && cuboid[2] <= wy && wy <= cuboid[3]
                  && cuboid[4] <= wz && wz <= cuboid[5])) continue;
            if (use_floor) {
                const float ax = fabsf(wx), ay = fabsf(wy);
                const float inv_pyr = ax > ay ? ax : ay;
                if (!(wz > (inv_pyr - 4.5f) / 3.5f)) continue;
            }

            // Preflat hue -> nearest cluster id; low saturation = background.
            float h, s;
            hue_sat(flat[p * 3 + 0], flat[p * 3 + 1], flat[p * 3 + 2], &h, &s);
            float inst = -1.0f;
            if (!((double)s < (double)sat_thresh)) {
                const double hue_r = (double)nearbyintf(h * 360.0f);
                double best = fabs(hue_r - clusters[0]);
                int64_t best_i = 0;
                for (int64_t c = 1; c < n_clusters; c++) {
                    const double d = fabs(hue_r - clusters[c]);
                    if (d < best) { best = d; best_i = c; }
                }
                inst = (float)best_i;
            }

            float* row = out + n_out * 7;
            row[0] = wx;
            row[1] = wy;
            row[2] = wz;
            row[3] = inst;
            row[4] = rgb[p * 3 + 0];
            row[5] = rgb[p * 3 + 1];
            row[6] = rgb[p * 3 + 2];
            n_out++;
        }
    }
    *n_valid_out = n_valid;
    return n_out;
}

}  // extern "C"
