// AVX512 PairHMM microbenchmark — baseline measurement only.
//
// An independent implementation of the 16-reads-per-vector float PairHMM
// forward scheme the reference uses on CPU (reference:
// src/haplotypecaller/pairhmm/rovaca/avx_512_float.cc — studied for the
// algorithm, implemented fresh here), so bench.py can report the TPU kernel's
// speedup against a measured AVX512 number on the current host instead of a
// guess.  Compile: gcc -O3 -mavx512f -mavx512dq pairhmm_avx_bench.c
//
// Usage: ./a.out <max_read_len> <hap_len> <n_iters>
// Prints: cells_per_second

#include <immintrin.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define LANES 16

static float frand(void) { return (float)rand() / (float)RAND_MAX; }

// One (16 reads x 1 hap) forward sweep, row-major with one column of state.
static void forward_16(int read_len, int hap_len, const int32_t* rbase,
                       const float* trans /* [read_len][8][LANES] */,
                       const int32_t* hap, float* result) {
    __m512* mm = aligned_alloc(64, sizeof(__m512) * (hap_len + 1));
    __m512* ii = aligned_alloc(64, sizeof(__m512) * (hap_len + 1));
    __m512* dd = aligned_alloc(64, sizeof(__m512) * (hap_len + 1));
    const float init_d = ldexpf(1.0f, 120) / (float)hap_len;
    for (int j = 0; j <= hap_len; j++) {
        mm[j] = _mm512_setzero_ps();
        ii[j] = _mm512_setzero_ps();
        dd[j] = _mm512_set1_ps(init_d);
    }
    for (int i = 0; i < read_len; i++) {
        const float* t = trans + (size_t)i * 8 * LANES;
        __m512i r = _mm512_load_epi32(rbase + (size_t)i * LANES);
        __m512 p_mm = _mm512_load_ps(t + 0 * LANES);
        __m512 p_gapm = _mm512_load_ps(t + 1 * LANES);
        __m512 p_mi = _mm512_load_ps(t + 2 * LANES);
        __m512 p_ii = _mm512_load_ps(t + 3 * LANES);
        __m512 p_md = _mm512_load_ps(t + 4 * LANES);
        __m512 p_dd = _mm512_load_ps(t + 5 * LANES);
        __m512 distm = _mm512_load_ps(t + 6 * LANES);
        __m512 one_distm = _mm512_load_ps(t + 7 * LANES);

        __m512 M_j1 = _mm512_setzero_ps(), I_j1 = M_j1, D_j1 = M_j1;
        __m512 M_d = M_j1, I_d = M_j1;
        __m512 D_d = i == 0 ? _mm512_set1_ps(init_d) : _mm512_setzero_ps();
        __m512 M_up = mm[0], I_up = ii[0], D_up = dd[0];
        for (int j = 0; j < hap_len; j++) {
            __m512i h = _mm512_set1_epi32(hap[j]);
            __mmask16 match = _mm512_test_epi32_mask(r, h);
            __m512 prior = _mm512_mask_blend_ps(match, distm, one_distm);
            __m512 M = _mm512_mul_ps(
                prior, _mm512_fmadd_ps(M_d, p_mm,
                                       _mm512_mul_ps(_mm512_add_ps(I_d, D_d),
                                                     p_gapm)));
            __m512 I = _mm512_fmadd_ps(M_up, p_mi, _mm512_mul_ps(I_up, p_ii));
            __m512 D = _mm512_fmadd_ps(M_j1, p_md, _mm512_mul_ps(D_j1, p_dd));
            M_d = M_up; I_d = I_up; D_d = D_up;
            M_j1 = M; I_j1 = I; D_j1 = D;
            mm[j] = M; ii[j] = I; dd[j] = D;
            M_up = mm[j + 1]; I_up = ii[j + 1]; D_up = dd[j + 1];
        }
    }
    __m512 sum = _mm512_setzero_ps();
    for (int j = 0; j < hap_len; j++)
        sum = _mm512_add_ps(sum, _mm512_add_ps(mm[j], ii[j]));
    _mm512_storeu_ps(result, sum);
    free(mm); free(ii); free(dd);
}

int main(int argc, char** argv) {
    // FTZ+DAZ, as the reference's engine sets (pairhmm_internal.cpp:21-25);
    // without it denormal underflow in the DP tail dominates runtime
    _MM_SET_FLUSH_ZERO_MODE(_MM_FLUSH_ZERO_ON);
    _MM_SET_DENORMALS_ZERO_MODE(_MM_DENORMALS_ZERO_ON);
    int read_len = argc > 1 ? atoi(argv[1]) : 128;
    int hap_len = argc > 2 ? atoi(argv[2]) : 384;
    int iters = argc > 3 ? atoi(argv[3]) : 50;

    srand(7);
    int32_t* rbase = aligned_alloc(64, sizeof(int32_t) * read_len * LANES);
    float* trans = aligned_alloc(64, sizeof(float) * read_len * 8 * LANES);
    int32_t* hap = aligned_alloc(64, sizeof(int32_t) * hap_len);
    float result[LANES];
    const int codes[4] = {1, 2, 4, 8};
    for (int i = 0; i < read_len * LANES; i++)
        rbase[i] = codes[rand() & 3];
    for (int j = 0; j < hap_len; j++) hap[j] = codes[rand() & 3];
    for (int i = 0; i < read_len; i++) {
        float* t = trans + (size_t)i * 8 * LANES;
        for (int l = 0; l < LANES; l++) {
            float gop = powf(10.f, -4.5f), gcp = powf(10.f, -1.0f);
            float q = powf(10.f, -(2.f + 2.f * frand()));
            t[0 * LANES + l] = 1.f - 2.f * gop;   // mm
            t[1 * LANES + l] = 1.f - gcp;         // gapm
            t[2 * LANES + l] = gop;               // mi
            t[3 * LANES + l] = gcp;               // ii
            t[4 * LANES + l] = gop;               // md
            t[5 * LANES + l] = gcp;               // dd
            t[6 * LANES + l] = q / 3.f;           // distm
            t[7 * LANES + l] = 1.f - q;           // 1-distm
        }
    }

    forward_16(read_len, hap_len, rbase, trans, hap, result);  // warmup

    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
    volatile float sink = 0.f;
    for (int k = 0; k < iters; k++) {
        forward_16(read_len, hap_len, rbase, trans, hap, result);
        sink += result[0];
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
    double dt = (t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec);
    double cells = (double)iters * LANES * read_len * hap_len;
    printf("%.6g\n", cells / dt);
    (void)sink;
    return 0;
}
