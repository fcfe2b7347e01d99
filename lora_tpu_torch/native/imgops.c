/* Native image preprocessing for the training data loader: one fused pass
 * doing a bilinear resize (short side -> out), the center crop and the
 * normalization to float32 in [-1, 1], parallel over output rows with
 * pthreads. The arithmetic is lora_tpu's native module's (PIL-convention
 * half-pixel centers, double precision, no antialiasing), behind a plain C
 * entry point that ctypes loads (native/build.py): no Python headers.
 *
 *   int lora_resize_crop_normalize(const uint8_t *src, long h, long w,
 *                                  long c, long out, float *dst);
 *
 * src is (h, w, c) uint8, HWC; dst receives (out, out, c) float32, HWC.
 * Returns 0, or -1 on bad dimensions. A thread that cannot start leaves
 * its rows to the caller's thread.
 */

#include <math.h>
#include <pthread.h>
#include <stdint.h>

typedef struct {
    const uint8_t *src;
    float *dst;
    long src_h, src_w, c;
    long out;             /* crop size */
    long top, left;       /* crop offset in resized space */
    double sy, sx;        /* source pixels per resized pixel */
    long row_begin, row_end;
} job_t;

static long clamp(long v, long hi) {
    return v < 0 ? 0 : (v >= hi ? hi - 1 : v);
}

static void *worker(void *arg) {
    job_t *j = (job_t *)arg;
    const long c = j->c;
    for (long oy = j->row_begin; oy < j->row_end; ++oy) {
        /* the output row's position in resized space, back-projected to
         * the source */
        double fy = ((double)(oy + j->top) + 0.5) * j->sy - 0.5;
        long y0 = (long)floor(fy);
        double wy = fy - (double)y0;
        const uint8_t *r0 = j->src + clamp(y0, j->src_h) * j->src_w * c;
        const uint8_t *r1 = j->src + clamp(y0 + 1, j->src_h) * j->src_w * c;
        float *out_row = j->dst + oy * j->out * c;
        for (long ox = 0; ox < j->out; ++ox) {
            double fx = ((double)(ox + j->left) + 0.5) * j->sx - 0.5;
            long x0 = (long)floor(fx);
            double wx = fx - (double)x0;
            long x0c = clamp(x0, j->src_w), x1c = clamp(x0 + 1, j->src_w);
            for (long ch = 0; ch < c; ++ch) {
                double top = (double)r0[x0c * c + ch] * (1.0 - wx)
                           + (double)r0[x1c * c + ch] * wx;
                double bot = (double)r1[x0c * c + ch] * (1.0 - wx)
                           + (double)r1[x1c * c + ch] * wx;
                double v = top * (1.0 - wy) + bot * wy;
                out_row[ox * c + ch] = (float)(v / 127.5 - 1.0);
            }
        }
    }
    return 0;
}

int lora_resize_crop_normalize(const uint8_t *src, long h, long w, long c,
                               long out, float *dst) {
    if (h <= 0 || w <= 0 || c <= 0 || out <= 0)
        return -1;
    /* the short side becomes `out`, the aspect kept */
    long rs_h, rs_w;
    if (w <= h) {
        rs_w = out;
        rs_h = (long)llround((double)h * out / (double)w);
        if (rs_h < out) rs_h = out;
    } else {
        rs_h = out;
        rs_w = (long)llround((double)w * out / (double)h);
        if (rs_w < out) rs_w = out;
    }
    enum { NT = 8 };
    pthread_t threads[NT];
    int started[NT] = {0};
    job_t jobs[NT];
    long chunk = (out + NT - 1) / NT;
    for (int t = 0; t < NT; ++t) {
        long begin = t * chunk, end = (t + 1) * chunk < out ? (t + 1) * chunk
                                                            : out;
        jobs[t] = (job_t){
            .src = src, .dst = dst, .src_h = h, .src_w = w, .c = c,
            .out = out, .top = (rs_h - out) / 2, .left = (rs_w - out) / 2,
            .sy = (double)h / (double)rs_h, .sx = (double)w / (double)rs_w,
            .row_begin = begin, .row_end = end,
        };
        if (begin >= end)
            continue;
        if (pthread_create(&threads[t], 0, worker, &jobs[t]) == 0)
            started[t] = 1;
        else
            worker(&jobs[t]);
    }
    for (int t = 0; t < NT; ++t)
        if (started[t])
            pthread_join(threads[t], 0);
    return 0;
}
