"""BQSR apply: base-quality recalibration from a GATK recalibration table.

Counterpart of the reference's BQSRReadTransformer (reference:
src/haplotypecaller/bqsr/bqsr_read_transformer.cpp:170-280,
bqsr_read_covarivates.cpp, apply_bqsr_utils.cpp:302-337): parse the
GATKReport table, build RG/QS/Context/Cycle recalibration tables, and
recalibrate each base via the hierarchical Bayesian estimate with the
Gaussian-prior / binomial-likelihood empirical quality.
"""

import math

import numpy as np

MAX_PHRED = 93                    # apply_bqsr_utils.h:45
MAX_RECAL_Q = 93
SMOOTHING = 1                     # RECALDATUM_SMOOTHING_CONSTANT
MAX_REASONABLE_Q = 60
MAX_USABLE_Q = 40
PRESERVE_Q_LESS_THAN = 6          # apply_bqsr_utils.h:64
LOW_QUAL_TAIL = 2                 # GATK ClippingRepresentation low-qual tail
CONTEXT_SIZE = 2                  # mismatches context
LENGTH_BITS = 4
MAX_CYCLE = 500

_BASE_INDEX = {65: 0, 67: 1, 71: 2, 84: 3}  # A C G T
_COMPLEMENT = bytes.maketrans(b"ACGTN", b"TGCAN")

# Gaussian prior over |Qemp - Qreported| (apply_bqsr_utils.cpp:15-22)
_LOG10_QEMP_PRIOR = np.array([
    -(d * d) / 2.0 * math.log10(math.e) / (0.5 ** 2 / 1.0)
    for d in range(MAX_USABLE_Q + 1)])
# exact table: -0.22579 - d^2*2 ... reproduce the reference values:
_LOG10_QEMP_PRIOR = np.array(
    [-0.22579135264472738 - 2.0 * d * d for d in range(MAX_USABLE_Q + 1)])


_TWO_PI = 2 * 3.141592653          # apply_bqsr_utils.cpp:12 (not math.tau!)
_HALF_LOG_2_PI = 0.5 * math.log(_TWO_PI)
# Apache Commons Math SaddlePointExpansion.EXACT_STIRLING_ERRORS — standard
# published constants, mirrored by apply_bqsr_utils.cpp:25-57. Half-integer
# Stirling-series errors for z = 0.0 .. 15.0 step 0.5.
_EXACT_STIRLING = [
    0.0, 0.1534264097200273452913848, 0.0810614667953272582196702,
    0.0548141210519176538961390, 0.0413406959554092940938221,
    0.03316287351993628748511048, 0.02767792568499833914878929,
    0.02374616365629749597132920, 0.02079067210376509311152277,
    0.01848845053267318523077934, 0.01664469118982119216319487,
    0.01513497322191737887351255, 0.01387612882307074799874573,
    0.01281046524292022692424986, 0.01189670994589177009505572,
    0.01110455975820691732662991, 0.010411265261972096497478567,
    0.009799416126158803298389475, 0.009255462182712732917728637,
    0.008768700134139385462952823, 0.008330563433362871256469318,
    0.007934114564314020547248100, 0.007573675487951840794972024,
    0.007244554301320383179543912, 0.006942840107209529865664152,
    0.006665247032707682442354394, 0.006408994188004207068439631,
    0.006171712263039457647532867, 0.005951370112758847735624416,
    0.005746216513010115682023589, 0.005554733551962801371038690,
]


def _deviance_part(x, mu):
    """getDeviancePart (apply_bqsr_utils.cpp:59-81). C float semantics:
    x/0 -> inf, log(inf) -> inf (Python would raise)."""
    if mu == 0.0:
        return math.inf if x > 0 else 0.0
    if abs(x - mu) < 0.1 * (x + mu):
        d = x - mu
        v = d / (x + mu)
        s1 = v * d
        s = float("nan")
        ej = 2.0 * x * v
        v *= v
        j = 1
        while s1 != s:
            s = s1
            ej *= v
            s1 = s + ej / (j * 2 + 1)
            j += 1
        return s1
    return x * math.log(x / mu) + mu - x


def _stirling_error(z):
    """getStirlingError (apply_bqsr_utils.cpp:84-105)."""
    if z < 15.0:
        z2 = 2.0 * z
        if math.floor(z2) == z2:
            return _EXACT_STIRLING[int(z2)]
        return math.lgamma(z + 1.0) - (z + 0.5) * math.log(z) \
            + z - _HALF_LOG_2_PI
    zz = z * z
    return (0.083333333333333333333 -
            (0.00277777777777777777778 -
             (0.00079365079365079365079365 -
              (0.000595238095238095238095238 -
               0.0008417508417508417508417508 / zz) / zz) / zz) / zz) / z


def _ln_binomial_probability(x, n, p, q):
    """logBinomialProbability (apply_bqsr_utils.cpp:107-133) — NATURAL log.
    The reference's log10_qual_emp_likelihood (:147-160) uses this natural-log
    value as if it were log10 — no conversion — so the binomial likelihood is
    effectively weighted ln(10)x stronger against the log10 prior. Bit-level
    parity with the reference binary requires reproducing that exactly."""
    if x == 0:
        if p < 0.1:
            return -_deviance_part(n, n * q) - n * p
        return n * math.log(q) if q > 0.0 else -math.inf
    if x == n:
        if q < 0.1:
            return -_deviance_part(n, n * p) - n * q
        return n * math.log(p) if p > 0.0 else -math.inf
    ret = (_stirling_error(n) - _stirling_error(x) - _stirling_error(n - x)
           - _deviance_part(x, n * p) - _deviance_part(n - x, n * q))
    f = (_TWO_PI * x * (n - x)) / n
    return -0.5 * math.log(f) + ret


_DBL_MAX = 1.7976931348623157e308


def _likelihood(q_emp, n_obs, n_err):
    """log10_qual_emp_likelihood (apply_bqsr_utils.cpp:147-160)."""
    if n_obs == 0:
        return 0.0
    p = 10.0 ** (q_emp * -0.1)
    if n_err < 0 or n_err > n_obs:
        return -_DBL_MAX
    ret = _ln_binomial_probability(n_err, n_obs, p, 1.0 - p)
    if math.isinf(ret) or math.isnan(ret):
        return -_DBL_MAX
    return ret


def empirical_quality_bayesian_estimate(n_obs, n_err, q_reported):
    """argmax over integer Qemp of prior + binomial likelihood
    (apply_bqsr_utils.cpp:302-316)."""
    best, best_q = -_DBL_MAX, 0
    for q in range(MAX_REASONABLE_Q + 1):
        d = min(abs(int(q - q_reported)), MAX_USABLE_Q)
        lp = _LOG10_QEMP_PRIOR[d] + _likelihood(float(q), n_obs, n_err)
        if lp > best:
            best, best_q = lp, q
    return float(best_q)


class RecalDatum:
    __slots__ = ("estimated_qual", "num_mismatches", "num_observations",
                 "_empirical")

    def __init__(self, n_obs, n_mismatch, reported_q):
        self.num_observations = int(n_obs)
        self.num_mismatches = float(n_mismatch)
        self.estimated_qual = float(reported_q)
        self._empirical = None

    def empirical_qual(self, conditional_prior):
        if self._empirical is None:
            errors = int(self.num_mismatches + 0.5) + SMOOTHING
            obs = self.num_observations + 2 * SMOOTHING
            self._empirical = min(
                empirical_quality_bayesian_estimate(obs, errors,
                                                    conditional_prior),
                float(MAX_RECAL_Q))
        return self._empirical


def parse_gatk_report(path):
    """{table_name: (col_names, rows)} from GATKReport text."""
    tables = {}
    with open(path) as fh:
        lines = fh.read().splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith("#:GATKTable:") and line.count(":") >= 4:
            parts = line.split(":")
            if parts[2].isdigit():
                ncols, nrows = int(parts[2]), int(parts[3])
                name = lines[i + 1].split(":")[2]
                header = lines[i + 2].split()
                rows = [lines[i + 3 + k].split() for k in range(nrows)]
                tables[name] = (header, rows)
                i += 3 + nrows
                continue
        i += 1
    return tables


def key_from_context(bases, start, end):
    if start < 0:
        return -1
    key = end - start
    offset = LENGTH_BITS
    for i in range(start, end):
        idx = _BASE_INDEX.get(bases[i])
        if idx is None:
            return -1
        key |= idx << offset
        offset += 2
    return key


def key_from_cycle(cycle, max_cycle=MAX_CYCLE):
    if abs(cycle) > max_cycle:
        return -1
    key = abs(cycle) << 1
    if cycle < 0:
        key += 1
    return key


class BQSRReadTransformer:
    def __init__(self, tables, read_groups=None):
        self.quantized = list(range(MAX_PHRED + 1))
        self.rg_index = {}
        self.rg_table = {}        # rg -> RecalDatum
        self.qs_table = {}        # (rg, q) -> RecalDatum
        self.context_table = {}   # (rg, q, key) -> RecalDatum
        self.cycle_table = {}     # (rg, q, key) -> RecalDatum
        self._load(tables)
        # the reference unconditionally disables quantization after the
        # table load (bqsr_read_transformer.cpp: ctor calls
        # quantization_info_->non_quantization()), so the Quantized table
        # is parsed but never applied
        self.quantized = list(range(MAX_PHRED + 1))

    @classmethod
    def from_table(cls, path):
        return cls(parse_gatk_report(path))

    def _rg_key(self, rg):
        if rg not in self.rg_index:
            self.rg_index[rg] = len(self.rg_index)
        return self.rg_index[rg]

    def _load(self, tables):
        if "Quantized" in tables:
            header, rows = tables["Quantized"]
            qcol = header.index("QuantizedScore")
            score_col = header.index("QualityScore")
            self.quantized = list(range(MAX_PHRED + 1))
            for row in rows:
                q = int(row[score_col])
                if q <= MAX_PHRED:
                    self.quantized[q] = int(row[qcol])
        if "RecalTable0" in tables:
            header, rows = tables["RecalTable0"]
            c = {n: header.index(n) for n in header}
            for row in rows:
                if row[c["EventType"]] != "M":
                    continue
                rg = self._rg_key(row[c["ReadGroup"]])
                self.rg_table[rg] = RecalDatum(
                    float(row[c["Observations"]]), float(row[c["Errors"]]),
                    float(row[c["EstimatedQReported"]]))
        if "RecalTable1" in tables:
            header, rows = tables["RecalTable1"]
            c = {n: header.index(n) for n in header}
            for row in rows:
                if row[c["EventType"]] != "M":
                    continue
                rg = self._rg_key(row[c["ReadGroup"]])
                q = int(row[c["QualityScore"]])
                self.qs_table[(rg, q)] = RecalDatum(
                    float(row[c["Observations"]]), float(row[c["Errors"]]),
                    q)
        if "RecalTable2" in tables:
            header, rows = tables["RecalTable2"]
            c = {n: header.index(n) for n in header}
            for row in rows:
                if row[c["EventType"]] != "M":
                    continue
                rg = self._rg_key(row[c["ReadGroup"]])
                q = int(row[c["QualityScore"]])
                val = row[c["CovariateValue"]]
                datum = RecalDatum(float(row[c["Observations"]]),
                                   float(row[c["Errors"]]), q)
                if row[c["CovariateName"]] == "Context":
                    key = key_from_context(val.encode(), 0, len(val))
                    self.context_table[(rg, q, key)] = datum
                elif row[c["CovariateName"]] == "Cycle":
                    key = key_from_cycle(int(val))
                    self.cycle_table[(rg, q, key)] = datum

    # ------------------------------------------------------------------
    def _covariates(self, read):
        """Per-base (context_key, cycle_key) mirroring compute_covariates."""
        n = len(read.bases)
        bases = read.bases
        quals = read.quals
        # low-qual tail clipping writes Ns
        left = 0
        right = n - 1
        while right >= 0 and quals[right] <= LOW_QUAL_TAIL:
            right -= 1
        while left < n and quals[left] <= LOW_QUAL_TAIL:
            left += 1
        clipped = bytearray(bases)
        for i in range(0, left):
            clipped[i] = ord("N")
        for i in range(right + 1, n):
            clipped[i] = ord("N")
        if read.is_reverse:
            clipped = bytearray(bytes(clipped).translate(_COMPLEMENT)[::-1])

        ctx_keys = [-1] * n
        for i in range(n):
            key = key_from_context(clipped, i - CONTEXT_SIZE + 1, i + 1)
            offset = n - i - 1 if read.is_reverse else i
            ctx_keys[offset] = key

        second = bool(read.flag & 0x80) and read.is_paired
        order = -1 if second else 1
        cyc_keys = [0] * n
        for i in range(n):
            if read.is_reverse:
                cycle = n * order - i * order
            else:
                cycle = order + i * order
            cyc_keys[i] = key_from_cycle(cycle)
        return ctx_keys, cyc_keys

    def apply(self, read):
        """Recalibrated copy of the read (bqsr_read_transformer.cpp:170).

        Read-group key: the reference's record_rg_covariate_value hardcodes
        key = 0 for every read (bqsr_read_covarivates.cpp:5-12) — the RG aux
        tag is never consulted, so all reads recalibrate against the FIRST
        read group's tables. Reproduced verbatim for bit-equivalence."""
        rg = 0
        rg_datum = self.rg_table.get(rg)
        new = read.copy()
        quals = new.quals
        epsilon = rg_datum.estimated_qual if rg_datum else 0.0
        ctx_keys, cyc_keys = self._covariates(read)
        for i in range(len(quals)):
            q = int(quals[i])
            if q < PRESERVE_Q_LESS_THAN:
                continue
            eps = epsilon
            delta_rg = (rg_datum.empirical_qual(eps) - eps) if rg_datum else 0.0
            eps2 = eps + delta_rg
            qs = self.qs_table.get((rg, q))
            delta_qs = (qs.empirical_qual(eps2) - eps2) if qs else 0.0
            cond = eps2 + delta_qs
            delta_cov = 0.0
            ctx = self.context_table.get((rg, q, ctx_keys[i]))
            if ctx is not None and ctx_keys[i] != -1:
                delta_cov += ctx.empirical_qual(cond) - cond
            cyc = self.cycle_table.get((rg, q, cyc_keys[i]))
            if cyc is not None and cyc_keys[i] != -1:
                delta_cov += cyc.empirical_qual(cond) - cond
            recal = cond + delta_cov
            bounded = max(min(int(recal + (0.5 if recal > 0 else -0.5)),
                              MAX_RECAL_Q), 1)
            quals[i] = self.quantized[bounded]
        return new
