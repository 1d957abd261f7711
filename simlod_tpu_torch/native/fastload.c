/* Native single-pass point-record decoders — the performance-parity counterpart of
 * the reference's C++ loaders (LasLoader.cpp:169-227, SimlodLoader.cpp:59-157).
 *
 * Built at first use by simlod_tpu_torch/native/__init__.py (cc -O3 -shared
 * -fPIC) and loaded via ctypes; no CPython API involved. These single-pass
 * decoders fuse the int32->float64 scale/offset/translate and the 16->8 bit RGB
 * conversion into one cache-friendly sweep; the numpy decode in formats/las.py
 * is their plain version, which the tests hold them to.
 */
#include <stdint.h>
#include <stddef.h>
#include <string.h>

/* Decode LAS point records.
 *   raw        : n * bpp bytes of point records
 *   rgb_off    : byte offset of the 3x uint16 RGB triple within a record, or -1
 *   scale/offset/trans : per-axis float64 coordinate transform
 *   out_xyz    : n * 3 float32
 *   out_rgba   : n uint32 (0xAABBGGRR, alpha 255)
 */
void simlod_decode_las(
    const uint8_t *raw, int64_t n, int32_t bpp, int32_t rgb_off,
    const double *scale, const double *offset, const double *trans,
    float *out_xyz, uint32_t *out_rgba)
{
    const double sx = scale[0], sy = scale[1], sz = scale[2];
    const double ox = offset[0] + trans[0];
    const double oy = offset[1] + trans[1];
    const double oz = offset[2] + trans[2];
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *rec = raw + i * (int64_t)bpp;
        int32_t xi, yi, zi;
        memcpy(&xi, rec + 0, 4);
        memcpy(&yi, rec + 4, 4);
        memcpy(&zi, rec + 8, 4);
        out_xyz[3 * i + 0] = (float)(xi * sx + ox);
        out_xyz[3 * i + 1] = (float)(yi * sy + oy);
        out_xyz[3 * i + 2] = (float)(zi * sz + oz);
        uint32_t r = 255, g = 255, b = 255;
        if (rgb_off >= 0 && rgb_off + 6 <= bpp) {
            uint16_t r16, g16, b16;
            memcpy(&r16, rec + rgb_off + 0, 2);
            memcpy(&g16, rec + rgb_off + 2, 2);
            memcpy(&b16, rec + rgb_off + 4, 2);
            /* 16-bit color detection per channel (LasLoader.cpp:216-222) */
            r = r16 > 255 ? (uint32_t)(r16 / 256) : r16;
            g = g16 > 255 ? (uint32_t)(g16 / 256) : g16;
            b = b16 > 255 ? (uint32_t)(b16 / 256) : b16;
        }
        out_rgba[i] = r | (g << 8) | (b << 16) | 0xFF000000u;
    }
}

/* Column variant: writes straight into caller-provided x/y/z/rgba column
 * buffers (the streaming layer's per-batch columns), with no strided
 * re-split of an [n, 3] array afterwards. */
void simlod_decode_las_cols(
    const uint8_t *raw, int64_t n, int32_t bpp, int32_t rgb_off,
    const double *scale, const double *offset, const double *trans,
    float *out_x, float *out_y, float *out_z, uint32_t *out_rgba)
{
    const double sx = scale[0], sy = scale[1], sz = scale[2];
    const double ox = offset[0] + trans[0];
    const double oy = offset[1] + trans[1];
    const double oz = offset[2] + trans[2];
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *rec = raw + i * (int64_t)bpp;
        int32_t xi, yi, zi;
        memcpy(&xi, rec + 0, 4);
        memcpy(&yi, rec + 4, 4);
        memcpy(&zi, rec + 8, 4);
        out_x[i] = (float)(xi * sx + ox);
        out_y[i] = (float)(yi * sy + oy);
        out_z[i] = (float)(zi * sz + oz);
        uint32_t r = 255, g = 255, b = 255;
        if (rgb_off >= 0 && rgb_off + 6 <= bpp) {
            uint16_t r16, g16, b16;
            memcpy(&r16, rec + rgb_off + 0, 2);
            memcpy(&g16, rec + rgb_off + 2, 2);
            memcpy(&b16, rec + rgb_off + 4, 2);
            r = r16 > 255 ? (uint32_t)(r16 / 256) : r16;
            g = g16 > 255 ? (uint32_t)(g16 / 256) : g16;
            b = b16 > 255 ? (uint32_t)(b16 / 256) : b16;
        }
        out_rgba[i] = r | (g << 8) | (b << 16) | 0xFF000000u;
    }
}

/* Decode .simlod records (16 B XYZRGBA) with an additional float3 shift, fused
 * (the streaming layer shifts per-file coordinates into the union frame). */
void simlod_decode_simlod(
    const uint8_t *raw, int64_t n, const float *shift,
    float *out_xyz, uint32_t *out_rgba)
{
    const float dx = shift[0], dy = shift[1], dz = shift[2];
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *rec = raw + i * 16;
        float x, y, z;
        uint32_t c;
        memcpy(&x, rec + 0, 4);
        memcpy(&y, rec + 4, 4);
        memcpy(&z, rec + 8, 4);
        memcpy(&c, rec + 12, 4);
        out_xyz[3 * i + 0] = x + dx;
        out_xyz[3 * i + 1] = y + dy;
        out_xyz[3 * i + 2] = z + dz;
        out_rgba[i] = c;
    }
}

/* Column variant of the .simlod decoder (see simlod_decode_las_cols). */
void simlod_decode_simlod_cols(
    const uint8_t *raw, int64_t n, const float *shift,
    float *out_x, float *out_y, float *out_z, uint32_t *out_rgba)
{
    const float dx = shift[0], dy = shift[1], dz = shift[2];
    for (int64_t i = 0; i < n; i++) {
        const uint8_t *rec = raw + i * 16;
        float x, y, z;
        uint32_t c;
        memcpy(&x, rec + 0, 4);
        memcpy(&y, rec + 4, 4);
        memcpy(&z, rec + 8, 4);
        memcpy(&c, rec + 12, 4);
        out_x[i] = x + dx;
        out_y[i] = y + dy;
        out_z[i] = z + dz;
        out_rgba[i] = c;
    }
}
