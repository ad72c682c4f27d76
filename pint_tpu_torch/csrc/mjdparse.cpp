// Native host kernel: batch decimal-MJD string -> (day, dd fraction).
//
// The ingestion hot loop (reference analog: the astropy fast C time
// parser behind src/pint/pulsar_mjd.py), a copy of
// pint_tpu/native/mjdparse.cpp. It mirrors the pure-Python parser
// (pint_tpu_torch/time/mjd.py parse_mjd_string) operation for operation,
// so the results are bit-identical.
//
// Build (done lazily by pint_tpu_torch.native, into build/):
//   g++ -O2 -ffp-contract=off -shared -fPIC -o mjdparse-<hash>.so
//       mjdparse.cpp
//
// ABI: plain C, consumed via ctypes.

#include <cstdint>
#include <cstring>

namespace {

struct DD {
  double hi, lo;
};

inline void two_sum(double a, double b, double &s, double &e) {
  s = a + b;
  double bb = s - a;
  e = (a - (s - bb)) + (b - bb);
}

inline void quick_two_sum(double a, double b, double &s, double &e) {
  s = a + b;
  e = b - (s - a);
}

// Dekker split (bit-identical to the numpy mirror, which cannot rely
// on hardware FMA either)
constexpr double SPLITTER = 134217729.0;  // 2^27 + 1

inline void two_prod(double a, double b, double &p, double &e) {
  p = a * b;
  double t = SPLITTER * a;
  double ah = t - (t - a);
  double al = a - ah;
  t = SPLITTER * b;
  double bh = t - (t - b);
  double bl = b - bh;
  e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
}

inline DD dd_norm(double hi, double lo) {
  double s, e, s2, e2;
  two_sum(hi, lo, s, e);
  quick_two_sum(s, e, s2, e2);
  return {s2, e2};
}

inline DD dd_add(DD a, DD b) {
  double s, e;
  two_sum(a.hi, b.hi, s, e);
  e += a.lo + b.lo;
  double s2, e2;
  quick_two_sum(s, e, s2, e2);
  return {s2, e2};
}

inline DD dd_mul_f(DD a, double b) {
  double p, e;
  two_prod(a.hi, b, p, e);
  double s2, e2;
  quick_two_sum(p, e + a.lo * b, s2, e2);
  return {s2, e2};
}

inline DD dd_div(DD a, DD b) {
  double q1 = a.hi / b.hi;
  DD prod = dd_mul_f(b, q1);
  DD r = dd_add(a, DD{-prod.hi, -prod.lo});
  double q2 = (r.hi + r.lo) / (b.hi + b.lo);
  double s, e;
  quick_two_sum(q1, q2, s, e);
  return {s, e};
}

inline double pow10i(int n) {
  double v = 1.0;
  while (n-- > 0) v *= 10.0;  // exact for n <= 22
  return v;
}

}  // namespace

extern "C" {

// Parse n NUL-terminated decimal MJD strings (concatenated in buf at
// byte offsets offs[i]) into day[i] (exact f64 integer part) and the
// dd fraction (fhi[i], flo[i]). Returns the index of the first bad
// string, or -1 on full success.
long long parse_mjd_batch(const char *buf, const long long *offs,
                          long long n, double *day, double *fhi,
                          double *flo) {
  for (long long i = 0; i < n; ++i) {
    const char *s = buf + offs[i];
    // match python str.strip(): all ASCII whitespace
    auto is_ws = [](char c) {
      return c == ' ' || c == '\t' || c == '\r' || c == '\n' ||
             c == '\f' || c == '\v';
    };
    while (is_ws(*s)) ++s;
    bool neg = false;
    if (*s == '-') {
      neg = true;
      ++s;
    }
    // integer part
    const char *p = s;
    long long ip = 0;
    int ip_digits = 0;
    while (*p >= '0' && *p <= '9') {
      if (ip_digits >= 18) return i;  // next accumulate would overflow
      ip = ip * 10 + (*p - '0');
      ++ip_digits;
      ++p;
    }
    int fp_digits = 0;
    char fp[31];
    if (*p == '.') {
      ++p;
      while (*p >= '0' && *p <= '9' && fp_digits < 30)
        fp[fp_digits++] = *p++;
      while (*p >= '0' && *p <= '9') ++p;  // ignore digits beyond 30
    }
    while (is_ws(*p)) ++p;
    if (*p != '\0' || (ip_digits == 0 && fp_digits == 0)) return i;
    // fraction: front 15 digits / 10^len + back 15 / 10^total — the
    // exact chunking the python mirror uses
    DD frac{0.0, 0.0};
    if (fp_digits > 0) {
      int alen = fp_digits < 15 ? fp_digits : 15;
      long long a = 0;
      for (int k = 0; k < alen; ++k) a = a * 10 + (fp[k] - '0');
      frac = dd_div(dd_norm((double)a, 0.0),
                    dd_norm(pow10i(alen), 0.0));
      if (fp_digits > 15) {
        long long b = 0;
        for (int k = 15; k < fp_digits; ++k) b = b * 10 + (fp[k] - '0');
        // two exact divisors (10^k only exact to k=22) — mirrors the
        // python fallback bit for bit
        DD fb = dd_div(dd_norm((double)b, 0.0),
                       dd_norm(pow10i(fp_digits - 15), 0.0));
        fb = dd_div(fb, dd_norm(pow10i(15), 0.0));
        frac = dd_add(frac, fb);
      }
    }
    day[i] = neg ? -(double)ip : (double)ip;
    if (neg) {
      fhi[i] = -frac.hi;
      flo[i] = -frac.lo;
    } else {
      fhi[i] = frac.hi;
      flo[i] = frac.lo;
    }
  }
  return -1;
}
}
