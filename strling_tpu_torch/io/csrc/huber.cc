// Batched Huber proposal-2 location/scale for the cohort outlier stage.
//
// Native twin of strling_tpu/core/outliers.py hubers_est_batch (itself the
// vectorized form of the reference's per-locus statsmodels loop,
// strling-outliers.py:115-136,300-314). Row-independent, multithreaded, and
// ARITHMETIC-IDENTICAL to the numpy path: sums use numpy's pairwise
// summation algorithm (8-way unrolled blocks <=128, recursive halving
// above) so mu/sd come out bitwise equal to the numpy implementation —
// the Python tests assert exact equality.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

// numpy _pairwise_sum (numpy/core/src/umath/loops.c.src) for stride-1
// doubles: n<8 sequential from res=a[0]+... ; 8<=n<=128 eight partial
// accumulators combined as ((r0+r1)+(r2+r3)) + ((r4+r5)+(r6+r7)); n>128
// split at n/2 rounded down to a multiple of 8.
static double pairwise_sum(const double* a, int64_t n) {
  if (n < 8) {
    double res = 0.0;
    for (int64_t i = 0; i < n; i++) res += a[i];
    return res;
  }
  if (n <= 128) {
    double r[8];
    for (int i = 0; i < 8; i++) r[i] = a[i];
    int64_t i;
    for (i = 8; i < n - (n % 8); i += 8)
      for (int j = 0; j < 8; j++) r[j] += a[i + j];
    double res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]));
    for (; i < n; i++) res += a[i];
    return res;
  }
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return pairwise_sum(a, n2) + pairwise_sum(a + n2, n - n2);
}

constexpr double MAD_C = 0.6744897501960817;  // Phi^-1(3/4)
constexpr double NaN = std::numeric_limits<double>::quiet_NaN();
constexpr double INF = std::numeric_limits<double>::infinity();

struct RowScratch {
  std::vector<double> sorted, tmp;
};

// np.median of the finite entries: sort (non-finite -> +inf), mean of the
// two middle order statistics computed as 0.5*(lo+hi) (numpy's mean of a
// 2-slice is (lo+hi)*0.5 — identical).
static double row_median(const double* x, const uint8_t* fin, int64_t S,
                         int64_t n_tot, RowScratch* rs) {
  if (n_tot == 0) return NaN;
  rs->sorted.resize(S);
  for (int64_t j = 0; j < S; j++) rs->sorted[j] = fin[j] ? x[j] : INF;
  std::sort(rs->sorted.begin(), rs->sorted.end());
  int64_t lo = (n_tot - 1) / 2, hi = n_tot / 2;
  return 0.5 * (rs->sorted[lo] + rs->sorted[hi]);
}

static void huber_rows(const double* X, int64_t L, int64_t S, double c,
                       double tol, int64_t maxiter, double gamma, double* out_mu,
                       double* out_sd, uint8_t* out_method, int64_t r0,
                       int64_t r1) {
  RowScratch rs;
  std::vector<uint8_t> fin(S);
  std::vector<double> x0(S), absdev(S), buf(S);
  for (int64_t r = r0; r < r1; r++) {
    const double* x = X + r * S;
    int64_t n_tot = 0;
    bool has_inf = false;
    for (int64_t j = 0; j < S; j++) {
      // only NaN is missing; +-inf are kept as values (they make the
      // scalar Huber raise on iteration 1 -> MAD fallback)
      fin[j] = std::isnan(x[j]) ? 0 : 1;
      has_inf |= fin[j] && std::isinf(x[j]);
      x0[j] = fin[j] ? x[j] : 0.0;
      n_tot += fin[j];
    }
    double med = row_median(x, fin.data(), S, n_tot, &rs);
    for (int64_t j = 0; j < S; j++)
      absdev[j] = fin[j] ? std::fabs(x[j] - med) : NaN;
    double mad = row_median(absdev.data(), fin.data(), S, n_tot, &rs) / MAD_C;

    bool failed = n_tot == 0 || has_inf;
    double mu = med, scale = mad;
    double rmu = NaN, rsd = NaN;
    bool done = false;
    const double n = (double)n_tot - 1.0;
    if (!failed) {
      for (int64_t it = 0; it < maxiter; it++) {
        if (!std::isfinite(scale) || scale == 0.0) {
          failed = true;
          break;
        }
        double lo = mu - c * scale, hi = mu + c * scale;
        for (int64_t j = 0; j < S; j++) {
          double v = x0[j] < lo ? lo : (x0[j] > hi ? hi : x0[j]);
          buf[j] = fin[j] ? v : 0.0;
        }
        double nmu = pairwise_sum(buf.data(), S) / (double)n_tot;
        int64_t card = 0;
        for (int64_t j = 0; j < S; j++) {
          bool in = fin[j] && std::fabs((x0[j] - mu) / scale) <= c;
          card += in;
          double d = x0[j] - nmu;
          buf[j] = in ? d * d : 0.0;
        }
        double scale_num = pairwise_sum(buf.data(), S);
        double scale_denom = n * gamma - ((double)n_tot - (double)card) * c * c;
        double ratio = scale_num / scale_denom;
        if (scale_denom == 0.0 || ratio < 0.0 || !std::isfinite(nmu)) {
          failed = true;
          break;
        }
        double nscale = std::sqrt(ratio);
        if (std::fabs(nmu - mu) <= nscale * tol &&
            std::fabs(nscale - scale) <= nscale * tol) {
          rmu = nmu;
          rsd = nscale;
          done = true;
          break;
        }
        mu = nmu;
        scale = nscale;
      }
      if (!done && !failed) failed = true;  // iteration overrun
    }
    if (failed) {
      rmu = med;
      rsd = mad;
    }
    if (rsd == 0.0) rsd = NaN;
    out_mu[r] = rmu;
    out_sd[r] = rsd;
    out_method[r] = failed ? 0 : 1;  // 0 = MAD fallback, 1 = Huber
  }
}

}  // namespace

extern "C" void sio_hubers_batch(const double* X, int64_t L, int64_t S,
                                 double c, double tol, int64_t maxiter,
                                 double gamma, double* out_mu, double* out_sd,
                                 uint8_t* out_method) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t T = std::max<int64_t>(1, std::min<int64_t>(hw ? hw : 1, L / 512 + 1));
  if (T == 1) {
    huber_rows(X, L, S, c, tol, maxiter, gamma, out_mu, out_sd, out_method, 0, L);
    return;
  }
  std::vector<std::thread> ts;
  int64_t chunk = (L + T - 1) / T;
  for (int64_t t = 0; t < T; t++) {
    int64_t r0 = t * chunk, r1 = std::min(L, r0 + chunk);
    if (r0 >= r1) break;
    ts.emplace_back(huber_rows, X, L, S, c, tol, maxiter, gamma, out_mu,
                    out_sd, out_method, r0, r1);
  }
  for (auto& th : ts) th.join();
}
