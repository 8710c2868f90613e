"""Hand-derived v2/tone golden vectors (VERDICT r4 missing #4).

Every expected array below was traced BY HAND from the Rust source —
not produced by the C++ oracle, the numpy oracle, or this repo's
implementations — so a misreading shared by both oracles would fail
here. The traces follow, line-referenced to /root/reference:

v2 step semantics (src/v2.rs):
  decode_beam_at (v2.rs:119-166): per active beam, per class d:
    tot = total_duration[w] + duration_table[d]          (:129)
    band: diag = U/T*(t+1); lower = trunc(max(diag-0.05U, 0));
          upper = trunc(min(diag+0.1U, U)); prune outside  (:94-104,131)
    overrun: (T-(t+1))*3 > U prunes everything             (:106-111,133)
    at t==T-1: tot must equal U exactly; candidate FINISHES (:135-150)
    zero_duration_id pruned unless allow_skip              (:139,152)
  finished/out-of-range beam -> single padding candidate
    (zero_duration_id, hist, t, u, finished, tot[w])       (:313-323)
  join: stable sort by lp desc (:280), adjacent dedup on
    eq_ignore_parent (:281), FIRST sorted on-diagonal candidate
    (diff = tot - U/T*next_t in [-20, 0], :113-117) re-injected into
    the last slot (:282-308), pad-by-repetition when short (:293-297).

All log-prob inputs are dyadic rationals so every sum is exact in f32.

Shared shape for cases 1-3: T=4, U=8, W=2, D=4, table=[0,1,2,3],
zero_duration_id=0, allow_skip=False, test_mode=False.

CASE 1 (mid-utterance band + tie + re-injection), t=1 for both beams:
  band: diag = 8/4*2 = 4.0 -> [trunc(3.6), trunc(4.8)] = [3, 4];
  overrun (4-2)*3 = 6 > 8? no.
  w0: hist=-1.0, tot0=2, u=1 -> d1(tot3, lp-1.5)OK d2(tot4, lp-1.75)OK
      d3(tot5)pruned.
  w1: hist=-1.5, tot0=3 -> d1(tot4, lp-1.75)OK d2,d3 pruned.
  sorted: [-1.5 w0d1] then the -1.75 TIE resolved by stable sort in
  generation order (gen = w*D+d: w0d2=2 < w1d1=5) -> [w0d1, w0d2, w1d1].
  no dedup (predictions differ). Re-injection: first sorted candidate
  with next_t=2 -> diag 4.0, diff = tot-4 in [-20,0]: w0d1 (diff -1).
  truncate to W-1 then push it -> BOTH slots = w0d1.

CASE 2 (exact-final-length at t=T-1), t=3, u=3 both:
  band: diag 8.0 -> [7, 8]; w0: hist=-2.0 tot0=6: d1 tot7 in band but
  != U -> pruned; d2 tot8 -> FINISHES, lp=-2.25; d3 tot9 pruned.
  w1: hist=-2.5 tot0=7: d1 tot8 lp=-2.625; others pruned.
  finished => next_t=t, next_u=u. diff = 8 - 8/4*3 = 2 -> NO
  re-injection. slots = [w0d2, w1d1].

CASE 3 (finished-beam padding + re-injection), w0 finished
  (hist=-3.0, t=3, u=4, tot0=8), w1 active (hist=-1.0, t=2, u=2,
  tot0=4): band diag 6.0 -> [5, 6]; w1: d1 tot5 lp-2.0, d2 tot6
  lp-1.5, d3 pruned. w0 pads (0, -3.0, 3, 4, fin, 8).
  sorted: [w1d2, w1d1, w0pad]. Re-injection: w1d2 diff = 6-6 = 0 ->
  truncate 1 + push -> BOTH slots = w1d2.

CASE 4 (pad-by-repetition, W=3): t=3, u=3, all active; tot0 =
  [6, 1, 2]; hist = [-1.0, -0.5, -0.5]; band [7, 8] & exact-final:
  only w0d2 (tot 8, lp -1.25) survives; w1/w2 produce EMPTY candidate
  vecs (active but fully pruned — not padding results). n=1 < 3 ->
  push results[0%1], results[1%1] (v2.rs:293-297). diff = 2 -> no
  re-injection. All three slots = w0d2 with branch 0.

Tone step semantics (src/tone_latent.rs:75-93, 184-234): every class
admissible for active beams, candidates never self-finish
(next=(t+1, u+1)), inactive beams pad with (empty_tone_id, hist, t, u,
finished); same stable sort + adjacent dedup.

CASE 5: T=3, K=3, W=2: w0 active (t=1, u=1, hist=-0.5,
  h=[-0.5, -0.25, -1.0]) -> cands (k0 -1.0)(k1 -0.75)(k2 -1.5) at
  (2,2); w1 finished (hist=-0.25, t=1, u=1) -> pad (0, -0.25, 1, 1).
  sorted: [w1pad -0.25, w0k1 -0.75, ...]; slots = [w1pad, w0k1].

CASE 6 (adjacent dedup): both beams identical state (t=1, u=1,
  hist=-0.5) and identical h=[-0.5, -0.25, -1.0]: each candidate
  appears twice with equal fields; stable sort keeps w0's copy first,
  dedup removes w1's (eq_ignore_parent ignores parent_branch) ->
  [w0k1 -0.75, w0k0 -1.0].
"""

import numpy as np
import jax.numpy as jnp

from ssnt_tts.ops import beam_v2, tone_latent


def _f(x):
    return jnp.asarray(x, jnp.float32)


def _i(x):
    return jnp.asarray(x, jnp.int32)


def _b(x):
    return jnp.asarray(x, bool)


def test_v2_hand_golden_cases_1_2_3():
    dtab = _i([0, 1, 2, 3])
    h = _f([
        # case 1
        [[-0.25, -0.5, -0.75, -1.0], [-0.125, -0.25, -0.375, -0.5]],
        # case 2
        [[-0.5, -0.5, -0.25, -0.5], [-0.5, -0.125, -0.5, -0.5]],
        # case 3 (w0 finished; its h row is irrelevant)
        [[-9.0, -9.0, -9.0, -9.0], [-2.0, -1.0, -0.5, -0.25]],
    ])
    hist = _f([[-1.0, -1.5], [-2.0, -2.5], [-3.0, -1.0]])
    fin = _b([[False, False], [False, False], [True, False]])
    tot = _i([[2, 3], [6, 7], [8, 4]])
    t = _i([[1, 1], [3, 3], [3, 2]])
    u = _i([[1, 1], [3, 3], [4, 2]])
    il = _i([4, 4, 4])
    ol = _i([8, 8, 8])

    (pred, lp, nt, nu, nfin, ntot, br) = beam_v2.beam_search_decode(
        h, hist, fin, tot, dtab, t, u, il, ol,
        zero_duration_id=0, allow_skip=False, test_mode=False,
    )
    np.testing.assert_array_equal(
        np.asarray(pred), [[1, 1], [2, 1], [2, 2]]
    )
    np.testing.assert_array_equal(
        np.asarray(lp),
        [[-1.5, -1.5], [-2.25, -2.625], [-1.5, -1.5]],
    )
    np.testing.assert_array_equal(np.asarray(nt), [[2, 2], [3, 3], [3, 3]])
    np.testing.assert_array_equal(np.asarray(nu), [[2, 2], [3, 3], [3, 3]])
    np.testing.assert_array_equal(
        np.asarray(nfin),
        [[False, False], [True, True], [False, False]],
    )
    np.testing.assert_array_equal(
        np.asarray(ntot), [[3, 3], [8, 8], [6, 6]]
    )
    np.testing.assert_array_equal(np.asarray(br), [[0, 0], [0, 1], [1, 1]])


def test_v2_hand_golden_case_4_pad_by_repetition():
    dtab = _i([0, 1, 2, 3])
    h = _f([[
        [-0.5, -0.5, -0.25, -0.5],
        [-0.5, -0.5, -0.5, -0.5],
        [-0.5, -0.5, -0.5, -0.5],
    ]])
    (pred, lp, nt, nu, nfin, ntot, br) = beam_v2.beam_search_decode(
        h, _f([[-1.0, -0.5, -0.5]]),
        _b([[False, False, False]]),
        _i([[6, 1, 2]]), dtab,
        _i([[3, 3, 3]]), _i([[3, 3, 3]]),
        _i([4]), _i([8]),
        zero_duration_id=0, allow_skip=False, test_mode=False,
    )
    np.testing.assert_array_equal(np.asarray(pred), [[2, 2, 2]])
    np.testing.assert_array_equal(np.asarray(lp), [[-1.25] * 3])
    np.testing.assert_array_equal(np.asarray(nt), [[3, 3, 3]])
    np.testing.assert_array_equal(np.asarray(nu), [[3, 3, 3]])
    np.testing.assert_array_equal(np.asarray(nfin), [[True] * 3])
    np.testing.assert_array_equal(np.asarray(ntot), [[8, 8, 8]])
    np.testing.assert_array_equal(np.asarray(br), [[0, 0, 0]])


def test_tone_hand_golden_cases_5_6():
    h = _f([
        [[-0.5, -0.25, -1.0], [-9.0, -9.0, -9.0]],
        [[-0.5, -0.25, -1.0], [-0.5, -0.25, -1.0]],
    ])
    hist = _f([[-0.5, -0.25], [-0.5, -0.5]])
    fin = _b([[False, True], [False, False]])
    t = _i([[1, 1], [1, 1]])
    u = _i([[1, 1], [1, 1]])
    il = _i([3, 3])
    (pred, lp, nt, nu, nfin, br) = tone_latent.beam_search_decode(
        h, hist, fin, t, u, il, empty_tone_id=0,
    )
    np.testing.assert_array_equal(np.asarray(pred), [[0, 1], [1, 0]])
    np.testing.assert_array_equal(
        np.asarray(lp), [[-0.25, -0.75], [-0.75, -1.0]]
    )
    np.testing.assert_array_equal(np.asarray(nt), [[1, 2], [2, 2]])
    np.testing.assert_array_equal(np.asarray(nu), [[1, 2], [2, 2]])
    np.testing.assert_array_equal(
        np.asarray(nfin), [[True, False], [False, False]]
    )
    np.testing.assert_array_equal(np.asarray(br), [[1, 0], [0, 0]])
