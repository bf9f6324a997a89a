/* Native host-side runtime kernels.
 *
 * The device owns the compute path (JAX/XLA); these are the host-sequential
 * pieces where Python is the wrong tool:
 *   - fnv_fold:        the per-pass image regression hash (an xor-multiply
 *                      chain, inherently sequential; counterpart of
 *                      image_cps_s_hash, reference src/scene.c:141-146)
 *   - pack_cps:        float RGB -> packed u32 pixels (cps_from_cl,
 *                      reference src/scene.c:76-83)
 *   - gen_samples:     sequential-LCG subpixel sample generation for the
 *                      adaptive gradient passes (reference
 *                      src/scene.c:1122-1139); resume-exact LCG threading
 *
 * Built as a plain shared object, bound via ctypes (no pybind11 in this
 * image).
 */

#include <stdint.h>
#include <stddef.h>

#define EXPORT __attribute__((visibility("default")))

EXPORT uint64_t fnv_fold(const uint64_t *data, size_t n)
{
    uint64_t h = 0xCBF29CE484222325ULL;
    for (size_t i = 0; i < n; i++)
        h = (h ^ data[i]) * 0x100000001B3ULL;
    return h;
}

EXPORT void pack_cps(const double *img, size_t n_px, uint32_t *out)
{
    for (size_t i = 0; i < n_px; i++) {
        const double *c = img + 3 * i;
        uint32_t v = 0;
        for (int k = 0; k < 3; k++) {
            double x = c[k];
            uint32_t b = x > 0.0 ? (x < 1.0 ? (uint32_t)(x * 256.0) : 255u)
                                 : 0u;
            v |= b << (8 * k);
        }
        out[i] = v;
    }
}

/* Knuth MMIX LCG matching actinon_tpu.rng.HostLcg */
static inline uint64_t lcg_next(uint64_t *s)
{
    *s = *s * 6364136223846793005ULL + 1442695040888963407ULL;
    return *s;
}

static inline double lcg_rnd1(uint64_t *s)
{
    return (double)lcg_next(s) * (1.0 / 18446744073709551615.0);
}

/* For each selected pixel (sel_x/sel_y, n_sel of them), draw
 * `samples_per_px` subpixel positions (x+dx, y+dy) with sequential LCG
 * draws (dx then dy per sample).  Returns the advanced LCG state. */
EXPORT uint64_t gen_samples(const int64_t *sel_x, const int64_t *sel_y,
                            size_t n_sel, int samples_per_px,
                            uint64_t state, double *out_xy)
{
    size_t o = 0;
    for (size_t i = 0; i < n_sel; i++) {
        for (int k = 0; k < samples_per_px; k++) {
            double dx = lcg_rnd1(&state);
            double dy = lcg_rnd1(&state);
            out_xy[o++] = (double)sel_x[i] + dx;
            out_xy[o++] = (double)sel_y[i] + dy;
        }
    }
    return state;
}
