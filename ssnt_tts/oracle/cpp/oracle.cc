// CPU oracle for conformance testing of the JAX ops.
//
// Native (C++) reimplementation of the reference semantics — the layer the
// reference implements in Rust (/root/reference/src/*.rs, studied and
// re-expressed, not translated line-by-line) — plus the SSNT
// forward-backward loss/grad the reference omits, computed here in double
// precision log-space as the golden standard for BASELINE config 0/1
// ("loss+grad vs CPU oracle").
//
// Exposed as a C ABI (loaded via ctypes from oracle/build.py), mirroring the
// reference's packaging shape (Rust core -> C ABI -> host framework,
// ssnt_tts_c/src/lib.rs).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Cand {
  int32_t prediction;
  float log_prob;
  int32_t next_t;
  int32_t next_u;
  bool is_finished;
  int32_t parent;
  int32_t total_duration;  // v2 only
};

inline bool eq_ignore_parent(const Cand& a, const Cand& b, bool with_dur) {
  bool same = a.prediction == b.prediction && a.log_prob == b.log_prob &&
              a.next_t == b.next_t && a.next_u == b.next_u &&
              a.is_finished == b.is_finished;
  if (with_dur) same = same && a.total_duration == b.total_duration;
  return same;
}

// Stable sort desc by log_prob, consecutive dedup vs last retained, pad by
// repeating survivors (modular), truncate to max_w. Reference semantics:
// src/lib.rs:160-169, src/v2.rs:279-308, src/tone_latent.rs:194-205.
void select(std::vector<Cand>& results, int max_w, bool with_dur,
            bool modular_pad) {
  std::stable_sort(results.begin(), results.end(),
                   [](const Cand& a, const Cand& b) {
                     return a.log_prob > b.log_prob;
                   });
  std::vector<Cand> dedup;
  for (const auto& r : results) {
    if (!dedup.empty() && eq_ignore_parent(r, dedup.back(), with_dur))
      continue;
    dedup.push_back(r);
  }
  results = dedup;
  const int n = static_cast<int>(results.size());
  if (n == 0) return;  // caller decides (reference panics, src/v2.rs:292)
  for (int i = 0; i < max_w - n; ++i)
    results.push_back(results[modular_pad ? (i % n) : i]);
  results.resize(max_w);
}

}  // namespace

extern "C" {

// ------------------------------------------------------------------ v1
// h (B, W, 2); state (B, W); outputs (B, max_w). Semantics: src/lib.rs.
void oracle_v1_beam_step(const float* h, const float* lph,
                         const uint8_t* fin, const int32_t* t,
                         const int32_t* u, const int32_t* input_length,
                         int32_t B, int32_t W, int32_t max_w,
                         int32_t* out_pred, float* out_lp, int32_t* out_t,
                         int32_t* out_u, uint8_t* out_fin,
                         int32_t* out_branch) {
  for (int b = 0; b < B; ++b) {
    const int T = input_length[b];
    std::vector<Cand> res;
    for (int w = 0; w < W; ++w) {
      const int base = b * W + w;
      const float hist = lph[base];
      const int tw = t[base], uw = u[base];
      if (!(tw >= 0 && tw < T) || fin[base]) {
        res.push_back({0, hist, tw, uw, true, w, 0});
        continue;
      }
      const bool last = tw == T - 1;
      const float he = h[(base)*2 + 0], hs = h[(base)*2 + 1];
      if (last) {
        res.push_back({0, hist + he, tw, uw, true, w, 0});
        res.push_back({0, hist, tw, uw, true, w, 0});  // shift prohibited
      } else {
        res.push_back({0, hist + he, tw, uw + 1, false, w, 0});
        res.push_back({1, hist + hs, tw + 1, uw + 1, false, w, 0});
      }
    }
    select(res, max_w, /*with_dur=*/false, /*modular_pad=*/false);
    for (int i = 0; i < max_w; ++i) {
      const auto& r = res[i];
      const int o = b * max_w + i;
      out_pred[o] = r.prediction;
      out_lp[o] = r.log_prob;
      out_t[o] = r.next_t;
      out_u[o] = r.next_u;
      out_fin[o] = r.is_finished;
      out_branch[o] = r.parent;
    }
  }
}

// ------------------------------------------------------------------ v2
// h (B, W, D); duration_table (D); state (B, W). Semantics: src/v2.rs.
// Returns number of batch elements whose beam emptied (reference panic).
int32_t oracle_v2_beam_step(const float* h, const float* lph,
                            const uint8_t* fin, const int32_t* total_dur,
                            const int32_t* dur_table, const int32_t* t,
                            const int32_t* u, const int32_t* input_length,
                            const int32_t* output_length, int32_t B,
                            int32_t W, int32_t D, int32_t max_w,
                            int32_t zero_duration_id, uint8_t allow_skip,
                            uint8_t test_mode, int32_t* out_pred,
                            float* out_lp, int32_t* out_t, int32_t* out_u,
                            uint8_t* out_fin, int32_t* out_total,
                            int32_t* out_branch) {
  int32_t empties = 0;
  for (int b = 0; b < B; ++b) {
    const int T = input_length[b];
    const int U = output_length[b];
    std::vector<Cand> res;
    for (int w = 0; w < W; ++w) {
      const int base = b * W + w;
      const float hist = lph[base];
      const int tw = t[base], uw = u[base];
      if (!(tw < T) || fin[base]) {
        res.push_back(
            {zero_duration_id, hist, tw, uw, true, w, total_dur[base]});
        continue;
      }
      const float diagonal =
          static_cast<float>(U) / static_cast<float>(T) *
          static_cast<float>(tw + 1);
      const float upper_range = static_cast<float>(U) * 0.1f;
      const float lower_range = static_cast<float>(U) * 0.05f;
      const int lower_bound =
          static_cast<int>(std::max(diagonal - lower_range, 0.0f));
      const int upper_bound = static_cast<int>(
          std::min(diagonal + upper_range, static_cast<float>(U)));
      const bool overrun = (T - (tw + 1)) * 3 > U;
      const bool last = tw == T - 1;
      for (int d = 0; d < D; ++d) {
        const int tot = total_dur[base] + dur_table[d];
        if (!test_mode && (tot < lower_bound || tot > upper_bound)) continue;
        if (!test_mode && overrun) continue;
        if (last) {
          if (!test_mode && tot != U) continue;
          if (!allow_skip && d == zero_duration_id) continue;
          res.push_back({d, hist + h[base * D + d], tw, uw, true, w, tot});
        } else {
          if (!allow_skip && d == zero_duration_id) continue;
          res.push_back(
              {d, hist + h[base * D + d], tw + 1, uw + 1, false, w, tot});
        }
      }
    }
    // Diagonal re-injection candidate (post-dedup order): src/v2.rs:282-308.
    std::stable_sort(res.begin(), res.end(),
                     [](const Cand& a, const Cand& b) {
                       return a.log_prob > b.log_prob;
                     });
    std::vector<Cand> dedup;
    for (const auto& r : res) {
      if (!dedup.empty() && eq_ignore_parent(r, dedup.back(), true)) continue;
      dedup.push_back(r);
    }
    res = dedup;
    bool have_diag = false;
    Cand diag_cand{};
    if (!test_mode) {
      for (const auto& r : res) {
        const float diag = static_cast<float>(U) / static_cast<float>(T) *
                           static_cast<float>(r.next_t);
        const float diff = static_cast<float>(r.total_duration) - diag;
        if (diff >= -20.0f && diff <= 0.0f) {
          have_diag = true;
          diag_cand = r;
          break;
        }
      }
    }
    const int n = static_cast<int>(res.size());
    if (n == 0) {
      ++empties;
      for (int i = 0; i < max_w; ++i) {
        const int o = b * max_w + i;
        out_pred[o] = zero_duration_id;
        out_lp[o] = 0.0f;
        out_t[o] = 0;
        out_u[o] = 0;
        out_fin[o] = 1;
        out_total[o] = 0;
        out_branch[o] = 0;
      }
      continue;
    }
    for (int i = 0; i < max_w - n; ++i) res.push_back(res[i % n]);
    res.resize(max_w);
    if (have_diag) {
      res.resize(max_w - 1);
      res.push_back(diag_cand);
    }
    for (int i = 0; i < max_w; ++i) {
      const auto& r = res[i];
      const int o = b * max_w + i;
      out_pred[o] = r.prediction;
      out_lp[o] = r.log_prob;
      out_t[o] = r.next_t;
      out_u[o] = r.next_u;
      out_fin[o] = r.is_finished;
      out_total[o] = r.total_duration;
      out_branch[o] = r.parent;
    }
  }
  return empties;
}

// ----------------------------------------------------------------- tone
// Semantics: src/tone_latent.rs.
void oracle_tone_beam_step(const float* h, const float* lph,
                           const uint8_t* fin, const int32_t* t,
                           const int32_t* u, const int32_t* input_length,
                           int32_t B, int32_t W, int32_t K, int32_t max_w,
                           int32_t empty_tone_id, int32_t* out_pred,
                           float* out_lp, int32_t* out_t, int32_t* out_u,
                           uint8_t* out_fin, int32_t* out_branch) {
  for (int b = 0; b < B; ++b) {
    const int T = input_length[b];
    std::vector<Cand> res;
    for (int w = 0; w < W; ++w) {
      const int base = b * W + w;
      const float hist = lph[base];
      const int tw = t[base], uw = u[base];
      if (!(tw < T) || fin[base]) {
        res.push_back({empty_tone_id, hist, tw, uw, true, w, 0});
        continue;
      }
      for (int k = 0; k < K; ++k)
        res.push_back(
            {k, hist + h[base * K + k], tw + 1, uw + 1, false, w, 0});
    }
    select(res, max_w, /*with_dur=*/false, /*modular_pad=*/true);
    for (int i = 0; i < max_w; ++i) {
      const auto& r = res[i];
      const int o = b * max_w + i;
      out_pred[o] = r.prediction;
      out_lp[o] = r.log_prob;
      out_t[o] = r.next_t;
      out_u[o] = r.next_u;
      out_fin[o] = r.is_finished;
      out_branch[o] = r.parent;
    }
  }
}

// ---------------------------------------------------- backtrace / upsample
// Semantics: src/util.rs, src/v2_util.rs.
void oracle_extract_best_beam_branch(const int32_t* best_final,
                                     const int32_t* beam_branch,
                                     const int32_t* t_history, int32_t B,
                                     int32_t U, int32_t W,
                                     int32_t* out_branch, int32_t* out_t) {
  for (int b = 0; b < B; ++b) {
    int cur = best_final[b];
    for (int row = U - 1; row >= 0; --row) {
      const int idx = (b * U + row) * W + cur;
      out_branch[b * U + row] = cur;
      out_t[b * U + row] = t_history[idx];
      cur = beam_branch[idx];
    }
  }
}

void oracle_order_beam_branch(const int32_t* final_branch,
                              const int32_t* beam_branch, int32_t B,
                              int32_t T, int32_t W, int32_t* out) {
  for (int b = 0; b < B; ++b)
    for (int w = 0; w < W; ++w) {
      int cur = final_branch[b * W + w];
      for (int row = T - 1; row >= 0; --row) {
        out[(b * W + w) * T + row] = cur;
        cur = beam_branch[(b * T + row) * W + cur];
      }
    }
}

void oracle_upsample(const int32_t* duration, const int32_t* output_length,
                     int32_t B, int32_t W, int32_t T, int32_t max_u,
                     int32_t fill, int32_t* out) {
  for (int b = 0; b < B; ++b)
    for (int w = 0; w < W; ++w) {
      int32_t* row = out + (b * W + w) * max_u;
      for (int j = 0; j < max_u; ++j) row[j] = fill;
      int pos = 0;
      const int limit = output_length[b * W + w];
      for (int tpos = 0; tpos < T && pos < limit; ++tpos) {
        const int d = duration[(b * W + w) * T + tpos];
        for (int k = 0; k < d && pos < limit; ++k) row[pos++] = tpos;
      }
    }
}

// ------------------------------------------------------------ edit distance
// Semantics: src/edit_distance.rs (two-row Kaldi DP).
void oracle_edit_distance(const int32_t* a, const int32_t* b,
                          const int32_t* a_len, const int32_t* b_len,
                          int32_t B, int32_t L, int32_t* out) {
  for (int i = 0; i < B; ++i) {
    const int M = a_len[i], N = b_len[i];
    std::vector<int32_t> e(N + 1), e_tmp(N + 1);
    for (int n = 0; n <= N; ++n) e[n] = n;
    for (int m = 1; m <= M; ++m) {
      e_tmp[0] = e[0] + 1;
      for (int n = 1; n <= N; ++n) {
        const int d = a[i * L + m - 1] == b[i * L + n - 1] ? 0 : 1;
        e_tmp[n] = std::min(e[n - 1] + d,
                            std::min(e[n] + 1, e_tmp[n - 1] + 1));
      }
      e = e_tmp;
    }
    out[i] = e[N];
  }
}

// ------------------------------------------- SSNT fwd-bwd loss (float64)
// The component the reference omits; double-precision golden standard.
// Shapes: (B, T, U) row-major. Outputs: loss (B), grads (B, T, U) x3.
void oracle_ssnt_loss_grad(const float* log_emit, const float* log_shift,
                           const float* log_frame,
                           const int32_t* input_length,
                           const int32_t* output_length, int32_t B,
                           int32_t Tmax, int32_t Umax, float* out_loss,
                           float* g_emit, float* g_shift, float* g_frame) {
  const double NEG = -1e300;
  auto lse = [](double x, double y) {
    if (x < y) std::swap(x, y);
    if (x <= -1e290) return x;
    return x + std::log1p(std::exp(y - x));
  };
  for (int b = 0; b < B; ++b) {
    const int T = input_length[b], U = output_length[b];
    auto LE = [&](int t, int u) {
      return static_cast<double>(log_emit[(b * Tmax + t) * Umax + u]);
    };
    auto LS = [&](int t, int u) {
      return static_cast<double>(log_shift[(b * Tmax + t) * Umax + u]);
    };
    auto LF = [&](int t, int u) {
      return static_cast<double>(log_frame[(b * Tmax + t) * Umax + u]);
    };
    std::vector<double> alpha(static_cast<size_t>(T) * U, NEG);
    std::vector<double> beta(static_cast<size_t>(T) * U, NEG);
    auto A = [&](int t, int u) -> double& { return alpha[t * U + u]; };
    auto Bt = [&](int t, int u) -> double& { return beta[t * U + u]; };
    A(0, 0) = LF(0, 0);
    for (int u = 1; u < U; ++u)
      for (int t = 0; t < T; ++t) {
        double s = A(t, u - 1) + LE(t, u - 1);
        if (t > 0) s = lse(s, A(t - 1, u - 1) + LS(t - 1, u - 1));
        A(t, u) = LF(t, u) + s;
      }
    const double logz = A(T - 1, U - 1) + LE(T - 1, U - 1);
    out_loss[b] = static_cast<float>(-logz);
    // beta
    Bt(T - 1, U - 1) = LE(T - 1, U - 1);
    for (int u = U - 2; u >= 0; --u)
      for (int t = T - 1; t >= 0; --t) {
        double s = LE(t, u) + LF(t, u + 1) + Bt(t, u + 1);
        if (t + 1 < T)
          s = lse(s, LS(t, u) + LF(t + 1, u + 1) + Bt(t + 1, u + 1));
        Bt(t, u) = s;
      }
    // posteriors -> grads of loss = -logz
    for (int t = 0; t < T; ++t)
      for (int u = 0; u < U; ++u) {
        const size_t o = (static_cast<size_t>(b) * Tmax + t) * Umax + u;
        double ce, cs;
        if (u == U - 1) {
          ce = (t == T - 1) ? 0.0 : NEG;
          cs = NEG;
        } else {
          ce = LF(t, u + 1) + Bt(t, u + 1);
          cs = (t + 1 < T) ? LF(t + 1, u + 1) + Bt(t + 1, u + 1) : NEG;
        }
        auto post = [&](double score) {
          const double s = score - logz;
          return (s < -700.0) ? 0.0 : std::exp(s);
        };
        g_emit[o] = static_cast<float>(-post(A(t, u) + LE(t, u) + ce));
        g_shift[o] = static_cast<float>(-post(A(t, u) + LS(t, u) + cs));
        g_frame[o] = static_cast<float>(-post(A(t, u) + Bt(t, u)));
      }
  }
}

}  // extern "C"
