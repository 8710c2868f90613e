"""Plain NumPy float64 reference of the SSNT model's forward pass.

Written independently of `models/` over the same parameter tree: a per-gate
GRU, a per-head attention loop, convolution as explicit taps, the frame
likelihood from the direct (B, T, U, M) squared error instead of the
factorized matmul, and the alpha recursion as a loop. Tests compare the
float32 model at the highest matmul precision against it.
"""

from __future__ import annotations

import math

import numpy as np


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return np.asarray(tree, np.float64)


def _dense(p, x):
    y = x @ p["kernel"]
    return y + p["bias"] if "bias" in p else y


def _ln(p, x, eps=1e-6):
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    return (x - mean) / np.sqrt(var + eps) * p["scale"] + p["bias"]


def _gelu(x):
    return 0.5 * x * (1 + np.tanh(math.sqrt(2 / math.pi)
                                  * (x + 0.044715 * x ** 3)))


def _sigmoid(x):
    return 1 / (1 + np.exp(-x))


def _log_softmax(x):
    m = x.max(-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(-1, keepdims=True))


def _gru(p, h, x):
    H = h.shape[-1]
    wi, wh, bi = p["wi"], p["wh"], p["bi"]
    gate = lambda w, i: w[..., i * H:(i + 1) * H]
    r = _sigmoid(x @ gate(wi, 0) + gate(bi, 0) + h @ gate(wh, 0))
    z = _sigmoid(x @ gate(wi, 1) + gate(bi, 1) + h @ gate(wh, 1))
    n = np.tanh(x @ gate(wi, 2) + gate(bi, 2)
                + r * (h @ gate(wh, 2) + p["bhn"]))
    return (1 - z) * n + z * h


def encode(params, cfg, tokens, lengths):
    p = _np(params)["encoder"]
    tokens = np.asarray(tokens)
    B, T = tokens.shape
    x = p["embed"]["embedding"][tokens]
    for lp in p["prenet"]:
        k = lp["conv"]["kernel"]  # (K, D, D)
        K = k.shape[0]
        pad = np.pad(x, ((0, 0), ((K - 1) // 2, K // 2), (0, 0)))
        y = sum(pad[:, j:j + T] @ k[j] for j in range(K)) + lp["conv"]["bias"]
        x = np.maximum(_ln(lp["ln"], y), 0)
    D = x.shape[-1]
    pos = np.arange(T)[:, None] * np.exp(
        np.arange(0, D, 2) * (-math.log(10000.0) / D))
    pe = np.zeros((T, D))
    pe[:, 0::2], pe[:, 1::2] = np.sin(pos), np.cos(pos)
    x = x + pe
    valid = np.arange(T)[None] < np.asarray(lengths)[:, None]  # (B, T)
    mask = valid[:, None, :] & valid[:, :, None]  # (B, Tq, Tk)
    H = cfg.encoder_heads
    hd = D // H
    for bp in p["blocks"]:
        y = _ln(bp["ln1"], x)
        qkv = _dense(bp["attn"]["qkv"], y)
        heads = []
        for h in range(H):
            q = qkv[..., h * hd:(h + 1) * hd]
            k_ = qkv[..., D + h * hd:D + (h + 1) * hd]
            v = qkv[..., 2 * D + h * hd:2 * D + (h + 1) * hd]
            logits = q @ np.swapaxes(k_, 1, 2) / math.sqrt(hd)
            logits = np.where(mask, logits, -1e30)
            w = np.exp(logits - logits.max(-1, keepdims=True))
            heads.append((w / w.sum(-1, keepdims=True)) @ v)
        x = x + _dense(bp["attn"]["out"], np.concatenate(heads, -1))
        y = _dense(bp["ff1"], _ln(bp["ln2"], x))
        x = x + _dense(bp["ff2"], _gelu(y))
    return _ln(p["ln_f"], x)


def _decoder_cell(p, h, mel_frame):
    x = np.maximum(_dense(p["prenet1"], mel_frame), 0)
    x = np.maximum(_dense(p["prenet2"], x), 0)
    return _gru(p["gru"], h, x)


def decoder_states(params, cfg, mel):
    p = _np(params)["ar_cell"]
    mel = np.asarray(mel, np.float64)
    B, U, _ = mel.shape
    h = np.zeros((B, cfg.decoder_dim))
    out = []
    prev = np.zeros_like(mel[:, 0])
    for u in range(U):
        h = _decoder_cell(p, h, prev)
        out.append(h)
        prev = mel[:, u]
    return np.stack(out, 1)


def lattice_quantities(params, cfg, enc, dec, mel):
    """(U, B, T) log_emit, log_shift, log_frame."""
    p = _np(params)
    tp, fp = p["transition"], p["frame"]
    R = cfg.joint_rank
    f = _dense(tp["enc_proj"], enc)  # (B, T, 2R)
    q = _dense(tp["dec_proj"], np.tanh(_dense(tp["dec_pre"], dec)))
    logit = np.stack(
        [np.einsum("btr,bur->ubt", f[..., k * R:(k + 1) * R],
                   q[..., k * R:(k + 1) * R]) for k in (0, 1)], -1)
    logit = (logit + _dense(tp["enc_bias"], enc)[None]
             + np.transpose(_dense(tp["dec_bias"], dec), (1, 0, 2))[:, :, None])
    norm = np.logaddexp(logit[..., 0], logit[..., 1])
    le, ls = logit[..., 0] - norm, logit[..., 1] - norm
    mean = (_dense(fp["enc_mel"], enc)[:, :, None]
            + _dense(fp["dec_mel"], dec)[:, None])  # (B, T, U, M)
    sq = ((np.asarray(mel, np.float64)[:, None] - mean) ** 2).sum(-1)
    M = mean.shape[-1]
    sig = fp["log_sigma"]
    lf = -0.5 * sq * np.exp(-2 * sig) - 0.5 * M * (
        math.log(2 * math.pi) + 2 * sig)
    return le, ls, np.transpose(lf, (2, 0, 1))


def lattice_nll(le, ls, lf, input_length, output_length):
    """Per-example NLL by the alpha recursion, one utterance at a time."""
    out = []
    for b, (Tb, Ub) in enumerate(zip(input_length, output_length)):
        alpha = np.full(int(Tb), -np.inf)
        alpha[0] = lf[0, b, 0]
        for u in range(1, int(Ub)):
            stay = alpha + le[u - 1, b, :Tb]
            move = np.concatenate([[-np.inf], (alpha + ls[u - 1, b, :Tb])[:-1]])
            alpha = lf[u, b, :Tb] + np.logaddexp(stay, move)
        out.append(-(alpha[Tb - 1] + le[Ub - 1, b, Tb - 1]))
    return np.asarray(out)


def nll(params, cfg, tokens, mel, input_length, output_length):
    enc = encode(params, cfg, tokens, input_length)
    dec = decoder_states(params, cfg, mel)
    return lattice_nll(*lattice_quantities(params, cfg, enc, dec, mel),
                       np.asarray(input_length), np.asarray(output_length))


def class_log_probs(params, head, enc):
    p = _np(params)[head]
    return _log_softmax(_dense(p["out"], np.maximum(_dense(p["h1"], enc), 0)))


def decode_step(params, cfg, enc, beam_t, dec_state, prev_mel):
    """(h (B, W, 2), new state, mel (B, W, M)) as SSNTModel.decode_step."""
    p = _np(params)
    enc_t = np.take_along_axis(np.asarray(enc, np.float64),
                               np.asarray(beam_t)[..., None], axis=1)
    h = _decoder_cell(p["ar_cell"], np.asarray(dec_state, np.float64),
                      np.asarray(prev_mel, np.float64))
    tp, fp, R = p["transition"], p["frame"], cfg.joint_rank
    f = _dense(tp["enc_proj"], enc_t)
    q = _dense(tp["dec_proj"], np.tanh(_dense(tp["dec_pre"], h)))
    logits = np.stack([(f[..., k * R:(k + 1) * R] * q[..., k * R:(k + 1) * R])
                       .sum(-1) for k in (0, 1)], -1)
    logits = logits + _dense(tp["enc_bias"], enc_t) + _dense(tp["dec_bias"], h)
    mel = _dense(fp["enc_mel"], enc_t) + _dense(fp["dec_mel"], h)
    return _log_softmax(logits), h, mel
