"""5-point minimal essential-matrix solver (Stewenius/Nister) — the port of
``coslam_tpu/geometry/fivepoint.py``: the same numpy algebra, with the
candidate scoring in PyTorch.

Replaces the reference's LibVisualSLAM ``geometry/SL_5point.h`` surface
(used by InitMap's extrinsic bootstrap, SL_InitMap.cpp:17,644-737, and
available to the merge E-estimation path). The normalized 8-point +
RANSAC path in ``geometry/epipolar.py`` remains the default for dense
in-pipeline estimation; the 5-point solver is strictly better on minimal
samples and near-planar wide-baseline bootstraps.

Design: the algebra (nullspace, Groebner-basis reduction, action matrix)
is *batched over RANSAC hypotheses* with numpy einsums against
precomputed monomial-product tables; the only per-hypothesis step is the
10x10 nonsymmetric eigendecomposition (np.linalg.eig batches natively).
This stage runs at host cadence (bootstrap/merge happen once / rarely);
candidate scoring over all points is one batched Sampson-error
computation on the host.

Convention matches epipolar.py: x2^T E x1 = 0 on normalized camera
coordinates (homogeneous z=1).
"""

from __future__ import annotations

import numpy as np

# monomial orderings (exponents of x, y, z)
_O1 = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
_O2 = [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2),
       (1, 0, 0), (0, 1, 0), (0, 0, 1), (0, 0, 0)]
# first 10 = leading cubic monomials, last 10 = quotient-ring basis (= _O2)
_O3 = [(3, 0, 0), (2, 1, 0), (2, 0, 1), (1, 2, 0), (1, 1, 1), (1, 0, 2),
       (0, 3, 0), (0, 2, 1), (0, 1, 2), (0, 0, 3)] + _O2


def _prod_table(oa, ob, oc):
    """T[i, j, k] = 1 where oa[i] * ob[j] == oc[k]."""
    idx = {m: k for k, m in enumerate(oc)}
    T = np.zeros((len(oa), len(ob), len(oc)))
    for i, a in enumerate(oa):
        for j, b in enumerate(ob):
            m = (a[0] + b[0], a[1] + b[1], a[2] + b[2])
            T[i, j, idx[m]] = 1.0
    return T


_T11 = _prod_table(_O1, _O1, _O2)    # [4, 4, 10]
_T21 = _prod_table(_O2, _O1, _O3)    # [10, 4, 20]


def five_point_candidates(x1n: np.ndarray, x2n: np.ndarray):
    """Essential-matrix candidates from minimal 5-point samples.

    x1n, x2n: [B, 5, 2] normalized camera coordinates. Returns
    (E [B, 10, 3, 3], valid [B, 10]) — up to 10 real solutions per
    hypothesis, zero-padded with valid=False.
    """
    x1n = np.asarray(x1n, np.float64)
    x2n = np.asarray(x2n, np.float64)
    B = x1n.shape[0]
    h1 = np.concatenate([x1n, np.ones_like(x1n[..., :1])], -1)  # [B, 5, 3]
    h2 = np.concatenate([x2n, np.ones_like(x2n[..., :1])], -1)
    # epipolar constraint rows: coefficient of E_ij is x2_i * x1_j
    A = np.einsum("bni,bnj->bnij", h2, h1).reshape(B, 5, 9)
    # 4-dim nullspace -> E(x,y,z) = x E1 + y E2 + z E3 + E4
    _, _, Vt = np.linalg.svd(A)
    Ebasis = Vt[:, 5:9].reshape(B, 4, 3, 3)                     # [B, 4, 3, 3]
    # coefficient tensor over the (x, y, z, 1) basis
    Ec = np.moveaxis(Ebasis, 1, -1)                             # [B, 3, 3, 4]

    # E E^T entries as degree-2 polynomials
    EEt = np.einsum("bijp,bkjq,pqm->bikm", Ec, Ec, _T11)        # [B,3,3,10]
    trace = EEt[:, 0, 0] + EEt[:, 1, 1] + EEt[:, 2, 2]          # [B, 10]
    # C = 2 E E^T E - tr(E E^T) E  (9 cubic polynomials)
    C = 2.0 * np.einsum("bikm,bkjp,mpn->bijn", EEt, Ec, _T21) \
        - np.einsum("bm,bijp,mpn->bijn", trace, Ec, _T21)       # [B,3,3,20]
    # det(E) as one cubic polynomial
    def m11(i1, j1, i2, j2):
        return np.einsum("bp,bq,pqm->bm", Ec[:, i1, j1], Ec[:, i2, j2], _T11)
    d1 = m11(1, 1, 2, 2) - m11(1, 2, 2, 1)
    d2 = m11(1, 0, 2, 2) - m11(1, 2, 2, 0)
    d3 = m11(1, 0, 2, 1) - m11(1, 1, 2, 0)
    # det = e00*d1 - e01*d2 + e02*d3 (deg2 * deg1 products)
    det = (np.einsum("bm,bp,mpn->bn", d1, Ec[:, 0, 0], _T21)
           - np.einsum("bm,bp,mpn->bn", d2, Ec[:, 0, 1], _T21)
           + np.einsum("bm,bp,mpn->bn", d3, Ec[:, 0, 2], _T21))  # [B, 20]

    M = np.concatenate([det[:, None], C.reshape(B, 9, 20)], 1)   # [B, 10, 20]
    # Gauss-Jordan: [I | Bred] over the leading cubic monomials
    lead, rest = M[:, :, :10], M[:, :, 10:]
    ok = np.abs(np.linalg.det(lead)) > 1e-16
    lead_safe = np.where(ok[:, None, None], lead,
                         np.eye(10)[None])
    Bred = np.linalg.solve(lead_safe, rest)                      # [B, 10, 10]

    # action matrix of multiplication by x on the quotient basis _O2:
    # x * {x2, xy, xz, y2, yz, z2} = leading monomials 0..5 -> -Bred rows;
    # x * {x, y, z, 1} = {x2, xy, xz, x} -> basis unit rows.
    Act = np.zeros((B, 10, 10))
    Act[:, :6] = -Bred[:, :6]
    Act[:, 6, 0] = 1.0   # x * x  = x^2
    Act[:, 7, 1] = 1.0   # x * y  = xy
    Act[:, 8, 2] = 1.0   # x * z  = xz
    Act[:, 9, 6] = 1.0   # x * 1  = x
    w, V = np.linalg.eig(Act)                                    # [B,10], [B,10,10]
    real = (np.abs(w.imag) < 1e-6 * (1 + np.abs(w.real))) & ok[:, None]
    Vr = V.real
    denom = Vr[:, 9, :]                                          # the "1" row
    good = real & (np.abs(denom) > 1e-12)
    denom = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    xs = Vr[:, 6, :] / denom
    ys = Vr[:, 7, :] / denom
    zs = Vr[:, 8, :] / denom
    E = (xs[:, :, None, None] * Ebasis[:, None, 0]
         + ys[:, :, None, None] * Ebasis[:, None, 1]
         + zs[:, :, None, None] * Ebasis[:, None, 2]
         + Ebasis[:, None, 3])                                   # [B,10,3,3]
    nrm = np.linalg.norm(E.reshape(B, 10, 9), axis=-1)
    E = E / np.maximum(nrm, 1e-12)[..., None, None]
    return E, good


def ransac_essential_5pt(x1n: np.ndarray, x2n: np.ndarray,
                         valid: np.ndarray, n_hyp: int = 128,
                         thresh: float = 2e-5, seed: int = 0):
    """Batched-hypothesis 5-point RANSAC on normalized coordinates.

    Returns (E [3,3], inlier_mask [N], n_inliers). ``thresh`` is on
    Sampson error (squared units), matching
    ``epipolar.ransac_fundamental``. Candidate solving is host numpy;
    scoring of all (hypothesis x candidate) models over all points is one
    batched tensor computation.
    """
    import torch
    from coslam_torch.geometry.epipolar import sampson_error

    x1n = np.asarray(x1n, np.float64)
    x2n = np.asarray(x2n, np.float64)
    valid = np.asarray(valid, bool)
    idx_all = np.nonzero(valid)[0]
    if len(idx_all) < 5:
        return np.eye(3), np.zeros(len(valid), bool), 0
    rng = np.random.default_rng(seed)
    samples = np.stack([rng.choice(idx_all, 5, replace=False)
                        for _ in range(n_hyp)])
    E, good = five_point_candidates(x1n[samples], x2n[samples])
    Eflat = E.reshape(-1, 3, 3)
    gflat = good.reshape(-1)
    d = sampson_error(
        torch.as_tensor(Eflat, dtype=torch.float32),
        torch.as_tensor(x1n[None], dtype=torch.float32),
        torch.as_tensor(x2n[None], dtype=torch.float32)).numpy()
    inl = (d < thresh) & valid[None] & gflat[:, None]
    counts = inl.sum(1)
    best = int(np.argmax(counts))
    return Eflat[best], inl[best], int(counts[best])
