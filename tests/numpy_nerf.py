"""Independent float64 numpy reference of the NeRF and image-field losses.

Forward and hand-written reverse pass of encode -> MLP -> head ->
compositing -> sum-MSE, written from the reference's semantics
(scripts/nerf.py, scripts/mlp_fit.py) without JAX, so the JAX pipeline's
values and autodiff gradients have something to be checked against.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-10


def encode(x, num_functions):
    """[x | sin(2^0 x) | cos(2^0 x) | ... ] over the last axis."""
    blocks = [x]
    for i in range(num_functions):
        blocks += [np.sin(2.0**i * x), np.cos(2.0**i * x)]
    return np.concatenate(blocks, axis=-1)


def _mlp_forward(ws, bs, x):
    """Pre-activations of every layer (the last is the head's input)."""
    pre, h = [], x
    for i, (w, b) in enumerate(zip(ws, bs)):
        z = h @ w + b
        pre.append((h, z))
        h = np.maximum(z, 0.0) if i < len(ws) - 1 else z
    return pre


def _mlp_backward(ws, pre, dz_last):
    """Weight/bias gradients given d(loss)/d(last pre-activation)."""
    dws, dbs = [None] * len(ws), [None] * len(ws)
    dz = dz_last
    for i in reversed(range(len(ws))):
        h, _ = pre[i]
        dws[i] = h.T @ dz
        dbs[i] = dz.sum(axis=0)
        if i:
            dz = (dz @ ws[i].T) * (pre[i - 1][1] > 0)
    return dws, dbs


def _sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


def nerf_loss_and_grads(ws, bs, origins, directions, t_vals, dists, target,
                        num_functions, mode):
    """Sum-MSE NeRF loss, rendered colors and (dW, db) in float64.

    ``t_vals``/``dists`` are (S,) shared by every ray or (N, S) per ray."""
    ws = [np.asarray(w, np.float64) for w in ws]
    bs = [np.asarray(b, np.float64) for b in bs]
    o = np.asarray(origins, np.float64)
    d = np.asarray(directions, np.float64)
    n = o.shape[0]
    t = np.broadcast_to(np.asarray(t_vals, np.float64), (n, t_vals.shape[-1]))
    dist = np.broadcast_to(np.asarray(dists, np.float64), t.shape)
    s = t.shape[1]
    pts = o[:, None, :] + d[:, None, :] * t[..., None]
    x = encode(pts, num_functions).reshape(n * s, -1)
    pre = _mlp_forward(ws, bs, x)
    y = pre[-1][1].reshape(n, s, -1)
    rgb = _sigmoid(y[..., :3])
    sigma = np.maximum(y[..., 3], 0.0)

    e = np.exp(-sigma * dist)
    alpha = 1.0 - e
    c = e + EPS
    incl = np.cumprod(c, axis=-1)
    if mode == "loma":  # inclusive cumprod with T[0] forced to 1
        trans = incl.copy()
        trans[:, 0] = 1.0
    elif mode == "standard":  # exclusive cumprod
        trans = np.concatenate([np.ones((n, 1)), incl[:, :-1]], axis=1)
    else:
        raise ValueError(mode)
    w = alpha * trans
    color = np.sum(w[..., None] * rgb, axis=1)
    resid = color - np.asarray(target, np.float64)
    loss = float(np.sum(resid * resid))

    g = 2.0 * resid                                  # dL/dcolor (N, 3)
    d_rgb = w[..., None] * g[:, None, :]             # (N, S, 3)
    a = np.sum(g[:, None, :] * rgb, axis=-1)         # dL/dw (N, S)
    d_alpha = a * trans
    d_trans = a * alpha
    # trans[s] = prod of c[k] over k <= s (loma, s >= 1) or k < s (standard):
    # dL/dc[k] = sum over the s whose product holds c[k] of d_trans*trans/c[k]
    contrib = d_trans * trans
    if mode == "loma":
        contrib[:, 0] = 0.0
        suffix = np.cumsum(contrib[:, ::-1], axis=1)[:, ::-1]  # s >= k
    else:
        suffix = np.cumsum(contrib[:, ::-1], axis=1)[:, ::-1]
        suffix = np.concatenate([suffix[:, 1:], np.zeros((n, 1))], axis=1)
    d_c = suffix / c
    d_e = d_c - d_alpha
    d_sigma = d_e * (-dist) * e

    dy = np.zeros_like(y)
    dy[..., :3] = d_rgb * rgb * (1.0 - rgb)
    dy[..., 3] = d_sigma * (y[..., 3] > 0)
    dws, dbs = _mlp_backward(ws, pre, dy.reshape(n * s, -1))
    return loss, color, dws, dbs


def image_fit_loss_and_grads(ws, bs, coords, target, num_functions):
    """Sum-MSE of the sigmoid-headed image field, predictions and grads."""
    ws = [np.asarray(w, np.float64) for w in ws]
    bs = [np.asarray(b, np.float64) for b in bs]
    x = encode(np.asarray(coords, np.float64), num_functions)
    pre = _mlp_forward(ws, bs, x)
    pred = _sigmoid(pre[-1][1])
    resid = pred - np.asarray(target, np.float64)
    loss = float(np.sum(resid * resid))
    dws, dbs = _mlp_backward(ws, pre, 2.0 * resid * pred * (1.0 - pred))
    return loss, pred, dws, dbs
