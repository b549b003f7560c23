// Fused PNG-decode + GREATER frame decode (data-plane hot path); own copy of
// occlusions4d_tpu/native/png_ops.cpp.
//
// Decoding three PNGs (rgb, preflat, depth) to 8/16-bit samples, converting
// each to a full float32 image in numpy and only then running the fused pixel
// pass of frame_ops.cpp costs more than the pass itself. This TU pulls the
// whole chain into one C++ call: a minimal PNG reader (zlib inflate + per-row
// unfilter; 8-bit gray/RGB/RGBA and 16-bit gray - the formats the GREATER
// data uses), a u8 -> f32/255 lookup-table conversion that reproduces numpy's
// `arr.astype(np.float32) / 255.0` bit-for-bit, and a tail call into
// o4d_greater_frame (frame_ops.cpp). Unsupported PNG flavors (palette,
// interlace, <8-bit) return an error and the Python wrapper falls back to the
// standard-library reader (data/png.py) + the frame pass.
//
// Bit-exactness contract: identical to frame_ops.cpp - the float conversions
// here are single-rounded f32 ops ((float)v / 255.0f, (float)v / 65535.0f,
// lut * scale) matching the numpy expressions of data/png.py::imread and
// the depth `* MAX_DEPTH_CLIP` line; compiled with -ffp-contract=off like the
// rest of the frame chain.

#include <cstdint>
#include <cstring>
#include <vector>

#include <zlib.h>

extern "C" int64_t o4d_greater_frame(const float* rgb, const float* flat,
                                     const float* depth, int64_t H, int64_t W,
                                     const float* iK, const float* iRT,
                                     const float* cuboid, int use_floor,
                                     const double* clusters, int64_t n_clusters,
                                     float sat_thresh, float* out,
                                     int64_t* n_valid_out);

namespace {

// Error codes surfaced to the ctypes wrapper (negative = fall back to data/png.py).
constexpr int64_t kUnsupported = -1;  // valid PNG, flavor we don't decode.
constexpr int64_t kCorrupt = -2;      // signature/chunk/inflate failure.
constexpr int64_t kMismatch = -3;     // images disagree on H x W.

struct PngImage {
    int64_t w = 0, h = 0;
    int channels = 0;   // samples per pixel after decode (1, 2, 3, 4).
    int depth16 = 0;    // 1 when 16-bit samples (big-endian in `data`).
    std::vector<uint8_t> data;  // unfiltered scanlines, no filter bytes.
};

inline uint32_t be32(const uint8_t* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16)
         | ((uint32_t)p[2] << 8) | (uint32_t)p[3];
}

inline uint8_t paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = p > a ? p - a : a - p;
    const int pb = p > b ? p - b : b - p;
    const int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

// Decode a whole PNG byte stream. Returns 0 or an error code above.
int64_t png_decode(const uint8_t* buf, int64_t len, PngImage* img) {
    static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    if (len < 8 + 25 || std::memcmp(buf, kSig, 8) != 0) return kCorrupt;

    int64_t pos = 8;
    int bit_depth = 0, color_type = 0;
    bool saw_ihdr = false, saw_iend = false;
    std::vector<uint8_t> idat;
    while (pos + 12 <= len) {
        const uint32_t clen = be32(buf + pos);
        const uint8_t* ctype = buf + pos + 4;
        const uint8_t* cdata = buf + pos + 8;
        if (pos + 12 + (int64_t)clen > len) return kCorrupt;
        if (!std::memcmp(ctype, "IHDR", 4)) {
            if (clen != 13) return kCorrupt;
            img->w = be32(cdata);
            img->h = be32(cdata + 4);
            bit_depth = cdata[8];
            color_type = cdata[9];
            const int interlace = cdata[12];
            if (img->w <= 0 || img->h <= 0) return kCorrupt;
            if (interlace != 0) return kUnsupported;
            if (bit_depth != 8 && bit_depth != 16) return kUnsupported;
            switch (color_type) {       // samples per pixel.
                case 0: img->channels = 1; break;  // gray.
                case 2: img->channels = 3; break;  // RGB.
                case 4: img->channels = 2; break;  // gray + alpha.
                case 6: img->channels = 4; break;  // RGBA.
                default: return kUnsupported;      // 3 = palette.
            }
            if (bit_depth == 16 && color_type != 0)
                return kUnsupported;  // 16-bit is depth-map-only territory.
            img->depth16 = bit_depth == 16;
            saw_ihdr = true;
        } else if (!std::memcmp(ctype, "IDAT", 4)) {
            if (!saw_ihdr) return kCorrupt;
            idat.insert(idat.end(), cdata, cdata + clen);
        } else if (!std::memcmp(ctype, "IEND", 4)) {
            saw_iend = true;
            break;
        }
        // Ancillary chunks (tEXt, gAMA, ...) are skipped; tRNS on the
        // supported color types never affects the consumed RGB/gray samples.
        pos += 12 + (int64_t)clen;
    }
    if (!saw_ihdr || !saw_iend || idat.empty()) return kCorrupt;

    const int64_t bpp = img->channels * (img->depth16 ? 2 : 1);
    const int64_t stride = img->w * bpp;
    const int64_t raw_len = img->h * (stride + 1);
    std::vector<uint8_t> raw((size_t)raw_len);
    uLongf dest_len = (uLongf)raw_len;
    const int zrc = uncompress(raw.data(), &dest_len, idat.data(),
                               (uLong)idat.size());
    if (zrc != Z_OK || dest_len != (uLongf)raw_len) return kCorrupt;

    img->data.resize((size_t)(img->h * stride));
    const uint8_t* prev = nullptr;  // previous unfiltered row.
    for (int64_t y = 0; y < img->h; y++) {
        const uint8_t* src = raw.data() + y * (stride + 1);
        uint8_t* dst = img->data.data() + y * stride;
        const int filter = src[0];
        src++;
        switch (filter) {
            case 0:
                std::memcpy(dst, src, (size_t)stride);
                break;
            case 1:  // Sub.
                for (int64_t i = 0; i < bpp; i++) dst[i] = src[i];
                for (int64_t i = bpp; i < stride; i++)
                    dst[i] = (uint8_t)(src[i] + dst[i - bpp]);
                break;
            case 2:  // Up.
                if (prev == nullptr) {
                    std::memcpy(dst, src, (size_t)stride);
                } else {
                    for (int64_t i = 0; i < stride; i++)
                        dst[i] = (uint8_t)(src[i] + prev[i]);
                }
                break;
            case 3:  // Average.
                for (int64_t i = 0; i < stride; i++) {
                    const int a = i >= bpp ? dst[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
                }
                break;
            case 4:  // Paeth.
                for (int64_t i = 0; i < stride; i++) {
                    const int a = i >= bpp ? dst[i - bpp] : 0;
                    const int b = prev ? prev[i] : 0;
                    const int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                    dst[i] = (uint8_t)(src[i] + paeth(a, b, c));
                }
                break;
            default:
                return kCorrupt;
        }
        prev = dst;
    }
    return 0;
}

// u8 -> float32 exactly as numpy's `u8.astype(np.float32) / 255.0`.
const float* u8_lut() {
    static float lut[256];
    static bool init = false;
    if (!init) {
        for (int v = 0; v < 256; v++) lut[v] = (float)v / 255.0f;
        init = true;
    }
    return lut;
}

// Expand the first three samples of each pixel to f32/255 (RGB consumers).
// Requires channels >= 3 (gray rgb/preflat images take the Python path).
bool to_f32_rgb(const PngImage& img, std::vector<float>* out) {
    if (img.depth16 || img.channels < 3) return false;
    const float* lut = u8_lut();
    const int64_t n = img.w * img.h;
    out->resize((size_t)(n * 3));
    const uint8_t* src = img.data.data();
    float* dst = out->data();
    const int c = img.channels;
    for (int64_t p = 0; p < n; p++) {
        dst[p * 3 + 0] = lut[src[p * c + 0]];
        dst[p * 3 + 1] = lut[src[p * c + 1]];
        dst[p * 3 + 2] = lut[src[p * c + 2]];
    }
    return true;
}

// Depth image to metric f32: channel 0, scaled-to-[0,1] then * scale — the
// exact numpy chain `_imread(fp) * MAX_DEPTH_CLIP` (two single-rounded ops).
bool to_f32_depth(const PngImage& img, float scale, std::vector<float>* out) {
    const int64_t n = img.w * img.h;
    out->resize((size_t)n);
    float* dst = out->data();
    if (img.depth16) {
        const uint8_t* src = img.data.data();  // big-endian u16, 1 channel.
        for (int64_t p = 0; p < n; p++) {
            const uint16_t v =
                (uint16_t)(((uint16_t)src[p * 2] << 8) | src[p * 2 + 1]);
            dst[p] = ((float)v / 65535.0f) * scale;
        }
        return true;
    }
    const float* lut = u8_lut();
    const uint8_t* src = img.data.data();
    const int c = img.channels;
    for (int64_t p = 0; p < n; p++) dst[p] = lut[src[p * c]] * scale;
    return true;
}

}  // namespace

extern "C" {

// Parse just the PNG header: fills wh_out = {W, H}; returns 0 or an error
// code. Lets the Python wrapper size the output buffer without decoding.
int64_t o4d_png_dims(const uint8_t* buf, int64_t len, int64_t* wh_out) {
    static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    if (len < 33 || std::memcmp(buf, kSig, 8) != 0) return kCorrupt;
    if (std::memcmp(buf + 12, "IHDR", 4) != 0) return kCorrupt;
    wh_out[0] = be32(buf + 16);
    wh_out[1] = be32(buf + 20);
    return 0;
}

// Fused: decode the three PNGs and run the o4d_greater_frame pixel pass.
// Parameters past the byte streams mirror o4d_greater_frame; depth_scale is
// MAX_DEPTH_CLIP. Returns rows written (>= 0) or an error code (< 0), in
// which case the caller falls back to the data/png.py + numpy chain.
int64_t o4d_greater_frame_png(
        const uint8_t* rgb_png, int64_t rgb_len,
        const uint8_t* flat_png, int64_t flat_len,
        const uint8_t* depth_png, int64_t depth_len, float depth_scale,
        const float* iK, const float* iRT, const float* cuboid, int use_floor,
        const double* clusters, int64_t n_clusters, float sat_thresh,
        float* out, int64_t* n_valid_out) {
    PngImage rgb, flat, depth;
    int64_t rc;
    if ((rc = png_decode(rgb_png, rgb_len, &rgb)) < 0) return rc;
    if ((rc = png_decode(flat_png, flat_len, &flat)) < 0) return rc;
    if ((rc = png_decode(depth_png, depth_len, &depth)) < 0) return rc;
    if (rgb.w != flat.w || rgb.h != flat.h || rgb.w != depth.w
            || rgb.h != depth.h)
        return kMismatch;

    std::vector<float> rgb_f, flat_f, depth_f;
    if (!to_f32_rgb(rgb, &rgb_f) || !to_f32_rgb(flat, &flat_f))
        return kUnsupported;
    if (!to_f32_depth(depth, depth_scale, &depth_f)) return kUnsupported;

    return o4d_greater_frame(rgb_f.data(), flat_f.data(), depth_f.data(),
                             rgb.h, rgb.w, iK, iRT, cuboid, use_floor,
                             clusters, n_clusters, sat_thresh, out,
                             n_valid_out);
}

}  // extern "C"
