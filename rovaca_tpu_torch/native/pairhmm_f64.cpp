// Scalar double-precision PairHMM forward for the f32->f64 rescue path.
//
// Role: the reference re-scores underflowed (read, haplotype) pairs in
// double (pairhmm_internal.cpp:674-689). Our rescue spec is the numpy
// golden oracle (ops/pairhmm/golden.py:forward_from_channels); this kernel
// reproduces its per-cell arithmetic bit-for-bit: identical operation
// order, no FMA contraction (built with -ffp-contract=off), and the final
// column sums left to numpy (np.sum's pairwise summation is part of the
// oracle's rounding behavior) — the caller gets the last M/I rows back.
//
//   M[i][j] = prior * (M[i-1][j-1]*mm + (I[i-1][j-1] + D[i-1][j-1])*gapm)
//   I[i][j] = M[i-1][j]*mi + I[i-1][j]*ii
//   D[i][j] = M[i][j-1]*md + D[i][j-1]*dd      (sequential in j)
//
// with D[-1][j] = initial_constant / hapLen and result rows M[Lr], I[Lr].
//
// Channels layout matches prep.prepare_read_channels: (8, Lr) doubles in
// order [mm, gapm, mi, ii, md, dd, distm, one_distm].

#include <cstdint>
#include <cstring>
#include <vector>

extern "C" void rovaca_pairhmm_f64_rows(const double* ch, const int32_t* codes,
                                        int32_t Lr, const int32_t* hap,
                                        int32_t Lh, double initial_constant,
                                        double* m_out, double* i_out) {
    const double* mm = ch + 0 * (size_t)Lr;
    const double* gapm = ch + 1 * (size_t)Lr;
    const double* mi = ch + 2 * (size_t)Lr;
    const double* ii = ch + 3 * (size_t)Lr;
    const double* md = ch + 4 * (size_t)Lr;
    const double* dd = ch + 5 * (size_t)Lr;
    const double* distm = ch + 6 * (size_t)Lr;
    const double* one_distm = ch + 7 * (size_t)Lr;

    const double init_d = initial_constant / (double)Lh;
    std::vector<double> Mp(Lh + 1, 0.0), Ip(Lh + 1, 0.0), Dp(Lh + 1, init_d);
    std::vector<double> Mr(Lh + 1), Ir(Lh + 1), Dr(Lh + 1);

    for (int32_t i = 0; i < Lr; i++) {
        const int32_t r = codes[i];
        Mr[0] = 0.0;
        Ir[0] = 0.0;
        Dr[0] = 0.0;
        for (int32_t j = 1; j <= Lh; j++) {
            const double prior = (r & hap[j - 1]) ? one_distm[i] : distm[i];
            Mr[j] = prior * (Mp[j - 1] * mm[i]
                             + (Ip[j - 1] + Dp[j - 1]) * gapm[i]);
            Ir[j] = Mp[j] * mi[i] + Ip[j] * ii[i];
        }
        double d = 0.0;
        for (int32_t j = 1; j <= Lh; j++) {
            d = md[i] * Mr[j - 1] + dd[i] * d;
            Dr[j] = d;
        }
        Mp.swap(Mr);
        Ip.swap(Ir);
        Dp.swap(Dr);
    }
    std::memcpy(m_out, Mp.data() + 1, sizeof(double) * (size_t)Lh);
    std::memcpy(i_out, Ip.data() + 1, sizeof(double) * (size_t)Lh);
}
