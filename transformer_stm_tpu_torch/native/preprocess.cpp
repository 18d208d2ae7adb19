// Native host-side image pipeline: JPEG decode (libjpeg) -> bilinear resize
// -> BT.601 grayscale, multithreaded.
//
// Replaces the reference's per-image Python loop of
// cv2.imread -> cv2.resize(INTER_LINEAR) -> cv2.cvtColor(BGR2GRAY)
// (reference: models/CvT(Par).py:418-423) with one C++ call over a batch of
// files.  The resize and grayscale stages replicate OpenCV's fixed-point
// arithmetic exactly (2048-scale bilinear coefficients, (1<<21)-rounded
// 22-bit vertical accumulation; 4899/9617/1868 BT.601 weights with 14-bit
// shift), so outputs are bit-identical to the cv2 pipeline whenever the
// JPEG decoder produces identical pixels.
//
// Exposed via ctypes (transformer_stm_tpu_torch/data/native.py, which builds
// it into transformer_stm_tpu_torch/_build/); built with
// `g++ -O3 -shared -fPIC preprocess.cpp -ljpeg -lpthread`.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

inline int clamp_i(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// OpenCV-compatible rounding: nearest, half to even (rint semantics).
inline int cv_round(double v) { return (int)lrint(v); }

inline short saturate_short(double v) {
    int i = cv_round(v);
    return (short)clamp_i(i, -32768, 32767);
}

inline uint8_t saturate_u8(int v) {
    return (uint8_t)clamp_i(v, 0, 255);
}

constexpr int kResizeBits = 11;                  // INTER_RESIZE_COEF_BITS
constexpr int kResizeScale = 1 << kResizeBits;   // 2048

// Bilinear resize of interleaved uint8 data, fixed-point, matching
// cv2.resize(..., INTER_LINEAR) for the downscale/upscale cases the
// pipeline hits (no area-fast path: cv2 only takes the fast path for
// integer 2x decimation, which 345x340 -> 128x128 never is).
void resize_bilinear_u8(const uint8_t* src, int sh, int sw, int channels,
                        uint8_t* dst, int dh, int dw) {
    const double scale_x = (double)sw / dw;
    const double scale_y = (double)sh / dh;

    std::vector<int> xofs(dw);
    std::vector<short> ax(dw * 2);
    for (int dx = 0; dx < dw; ++dx) {
        double fx = (dx + 0.5) * scale_x - 0.5;
        int sx = (int)std::floor(fx);
        fx -= sx;
        if (sx < 0) { sx = 0; fx = 0.0; }
        if (sx >= sw - 1) { sx = sw - 2; fx = 1.0; }
        xofs[dx] = sx;
        ax[dx * 2] = saturate_short((1.0 - fx) * kResizeScale);
        ax[dx * 2 + 1] = saturate_short(fx * kResizeScale);
    }
    std::vector<int> yofs(dh);
    std::vector<short> ay(dh * 2);
    for (int dy = 0; dy < dh; ++dy) {
        double fy = (dy + 0.5) * scale_y - 0.5;
        int sy = (int)std::floor(fy);
        fy -= sy;
        if (sy < 0) { sy = 0; fy = 0.0; }
        if (sy >= sh - 1) { sy = sh - 2; fy = 1.0; }
        yofs[dy] = sy;
        ay[dy * 2] = saturate_short((1.0 - fy) * kResizeScale);
        ay[dy * 2 + 1] = saturate_short(fy * kResizeScale);
    }

    // horizontal pass for the two source rows each output row needs
    std::vector<int> row0(dw * channels), row1(dw * channels);
    int prev_sy = -2;
    for (int dy = 0; dy < dh; ++dy) {
        int sy = yofs[dy];
        auto hresize = [&](const uint8_t* srow, int* drow) {
            for (int dx = 0; dx < dw; ++dx) {
                const uint8_t* p = srow + xofs[dx] * channels;
                int a0 = ax[dx * 2], a1 = ax[dx * 2 + 1];
                for (int c = 0; c < channels; ++c) {
                    drow[dx * channels + c] =
                        p[c] * a0 + p[channels + c] * a1;  // scale 2^11
                }
            }
        };
        if (sy == prev_sy) {
            // rows already computed
        } else if (sy == prev_sy + 1) {
            row0.swap(row1);
            hresize(src + (size_t)(sy + 1) * sw * channels, row1.data());
        } else {
            hresize(src + (size_t)sy * sw * channels, row0.data());
            hresize(src + (size_t)(sy + 1) * sw * channels, row1.data());
        }
        prev_sy = sy;

        int b0 = ay[dy * 2], b1 = ay[dy * 2 + 1];
        uint8_t* drow = dst + (size_t)dy * dw * channels;
        for (int i = 0; i < dw * channels; ++i) {
            // OpenCV's specialised uchar vertical pass
            // (VResizeLinear<uchar, int, short, ...>):
            //   dst = (((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2
            int v = ((b0 * (row0[i] >> 4)) >> 16)
                  + ((b1 * (row1[i] >> 4)) >> 16);
            drow[i] = saturate_u8((v + 2) >> 2);
        }
    }
}

// BGR -> gray with OpenCV's fixed-point BT.601 (R*4899 + G*9617 + B*1868,
// 14-bit shift, round-half-up).
void bgr2gray_u8(const uint8_t* bgr, int n_pixels, uint8_t* gray) {
    constexpr int R = 4899, G = 9617, B = 1868, SHIFT = 14;
    constexpr int HALF = 1 << (SHIFT - 1);
    for (int i = 0; i < n_pixels; ++i) {
        const uint8_t* p = bgr + i * 3;
        gray[i] = (uint8_t)((p[0] * B + p[1] * G + p[2] * R + HALF) >> SHIFT);
    }
}

struct JpegErr {
    jpeg_error_mgr mgr;
    jmp_buf jb;
};

void jpeg_err_exit(j_common_ptr cinfo) {
    JpegErr* err = (JpegErr*)cinfo->err;
    longjmp(err->jb, 1);
}

// Decode a baseline JPEG to interleaved BGR uint8 (cv2.imread layout).
// Returns true on success.
bool decode_jpeg_bgr(const char* path, std::vector<uint8_t>* out,
                     int* h, int* w) {
    FILE* f = fopen(path, "rb");
    if (!f) return false;
    jpeg_decompress_struct cinfo;
    JpegErr jerr;
    cinfo.err = jpeg_std_error(&jerr.mgr);
    jerr.mgr.error_exit = jpeg_err_exit;
    if (setjmp(jerr.jb)) {
        jpeg_destroy_decompress(&cinfo);
        fclose(f);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_EXT_BGR;  // libjpeg-turbo ext; see fallback
    jpeg_start_decompress(&cinfo);
    *h = cinfo.output_height;
    *w = cinfo.output_width;
    int ch = cinfo.output_components;
    out->resize((size_t)(*h) * (*w) * 3);
    std::vector<uint8_t> row((size_t)(*w) * ch);
    uint8_t* rp = row.data();
    for (int y = 0; y < *h; ++y) {
        jpeg_read_scanlines(&cinfo, &rp, 1);
        uint8_t* dst = out->data() + (size_t)y * (*w) * 3;
        if (ch == 3) {
            memcpy(dst, rp, (size_t)(*w) * 3);
        } else {  // grayscale jpeg -> replicate
            for (int x = 0; x < *w; ++x) {
                dst[x * 3] = dst[x * 3 + 1] = dst[x * 3 + 2] = rp[x];
            }
        }
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return true;
}

}  // namespace

extern "C" {

// Resize + grayscale one BGR image (for parity tests and cached pipelines).
void tstm_resize_gray(const uint8_t* bgr, int sh, int sw,
                      uint8_t* gray_out, int dh, int dw) {
    std::vector<uint8_t> resized((size_t)dh * dw * 3);
    resize_bilinear_u8(bgr, sh, sw, 3, resized.data(), dh, dw);
    bgr2gray_u8(resized.data(), dh * dw, gray_out);
}

// Full batch pipeline: decode `n` JPEG files -> resize (dh, dw) -> gray.
// paths: array of n C strings; out: n*dh*dw uint8 buffer.
// Returns the number of successfully processed images; failures leave
// their slot zeroed.  `threads` <= 0 means hardware concurrency.
int tstm_decode_batch(const char** paths, int n, int dh, int dw,
                      uint8_t* out, int threads) {
    if (threads <= 0) threads = (int)std::thread::hardware_concurrency();
    threads = std::max(1, std::min(threads, n));
    std::atomic<int> next(0), ok(0);
    auto worker = [&]() {
        std::vector<uint8_t> bgr;
        std::vector<uint8_t> resized((size_t)dh * dw * 3);
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n) break;
            int h = 0, w = 0;
            if (!decode_jpeg_bgr(paths[i], &bgr, &h, &w)) {
                memset(out + (size_t)i * dh * dw, 0, (size_t)dh * dw);
                continue;
            }
            resize_bilinear_u8(bgr.data(), h, w, 3, resized.data(), dh, dw);
            bgr2gray_u8(resized.data(), dh * dw, out + (size_t)i * dh * dw);
            ok.fetch_add(1);
        }
    };
    std::vector<std::thread> pool;
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
    return ok.load();
}

}  // extern "C"
