"""Classic trRosetta input features: reweighting, PSSM, fast DCA.

PyTorch counterparts of trx2dy/models/features.py (utils_trX2dy/utils.py:
641-702). The (21L x 21L) regularized covariance is symmetric positive
definite by construction, so its inverse is a Cholesky factorisation plus
`cholesky_inverse`; at L=400 the matrix is 8400^2 in float32.

Feature layout (526 = 2*42 + 442):
  f1d (L, 42) = [query one-hot(20) | PSSM(21) | entropy(1)]
  f2d (L, L, 526) = [tile_i f1d | tile_j f1d | DCA features(441) + APC(1)]

Products run in full float32: callers go through device.resolve_device,
which turns TF32 off, so the identity counts of `reweight` are exact.
"""
from __future__ import annotations

import torch

from trx2dy_torch.utils.profiling import span

N_TOKENS = 21


def reweight(msa1hot: torch.Tensor, cutoff: float = 0.8) -> torch.Tensor:
    """Sequence weights: 1 / (# sequences with >= cutoff identity)."""
    R, L, A = msa1hot.shape
    x = msa1hot.reshape(R, L * A)
    id_mtx = x @ x.T
    id_mask = id_mtx > L * cutoff
    return 1.0 / id_mask.sum(dim=-1).to(msa1hot.dtype)


def msa2pssm(msa1hot: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted PSSM + per-position entropy, (L, 22)."""
    beff = w.sum()
    f_i = (w[:, None, None] * msa1hot).sum(dim=0) / beff + 1e-9
    h_i = (-f_i * torch.log(f_i)).sum(dim=1)
    return torch.cat([f_i, h_i[:, None]], dim=1)


def fast_dca(msa1hot: torch.Tensor, weights: torch.Tensor,
             penalty: float = 4.5) -> torch.Tensor:
    """Regularized inverse-covariance DCA + APC-corrected contacts,
    (L, L, 442)."""
    nr, nc, ns = msa1hot.shape
    n = nc * ns
    x = msa1hot.reshape(nr, n)
    num_points = weights.sum() - torch.sqrt(weights.mean())
    mean = (x * weights[:, None]).sum(dim=0, keepdim=True) / num_points
    x = (x - mean) * torch.sqrt(weights[:, None])
    cov = (x.T @ x) / num_points

    eye = torch.eye(n, dtype=x.dtype, device=x.device)
    cov_reg = cov + eye * (penalty / torch.sqrt(weights.sum()))
    inv_cov = torch.cholesky_inverse(torch.linalg.cholesky(cov_reg))

    x1 = inv_cov.reshape(nc, ns, nc, ns)
    features = x1.permute(0, 2, 1, 3).reshape(nc, nc, ns * ns)
    off_diag = 1 - torch.eye(nc, dtype=x.dtype, device=x.device)
    x3 = torch.sqrt(x1[:, :-1, :, :-1].square().sum(dim=(1, 3))) * off_diag
    apc = x3.sum(dim=0, keepdim=True) * x3.sum(dim=1, keepdim=True) / x3.sum()
    contacts = (x3 - apc) * off_diag
    return torch.cat([features, contacts[:, :, None]], dim=2)


def get_f2d(msa: torch.Tensor) -> torch.Tensor:
    """Full 526-dim pair features (L, L, 526) from an (R, L) token MSA."""
    with span("features"):
        nrow, ncol = msa.shape
        msa1hot = torch.nn.functional.one_hot(
            msa.long(), N_TOKENS).to(torch.float32)
        w = reweight(msa1hot, 0.8)

        f1d_seq = msa1hot[0, :, :20]
        f1d_pssm = msa2pssm(msa1hot, w)
        f1d = torch.cat([f1d_seq, f1d_pssm], dim=1)          # (L, 42)

        if nrow > 1:
            f2d_dca = fast_dca(msa1hot, w)
        else:
            f2d_dca = msa1hot.new_zeros((ncol, ncol, 442))

        return torch.cat([
            f1d[:, None, :].expand(ncol, ncol, f1d.shape[1]),
            f1d[None, :, :].expand(ncol, ncol, f1d.shape[1]),
            f2d_dca,
        ], dim=-1)
