"""Synthetic ZESHEL-like cross-encoder domain — port of
``SyntheticCE``/``make_synthetic_ce`` from ``repro/data/synthetic.py``.

    score(q, i) = sum_r w_r · <tanh(A_r e_q), tanh(B_r e_i)>     (background)
                + gamma · exp(-||e_q - e_i||² / (2σ²))           (k-NN spikes)

Bulk scoring is chunked over items so no temporary grows past a few
hundred MB (the serving domain has 10^6 items); the background of a block
is one (Q, R·r) x (R·r, N) fp32 matrix product.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core import prng
from ..device import resolve_device

_CHUNK_ELEMS = 1 << 26      # (Q, N_chunk, d) fp32 temporaries: 256 MB


@dataclass
class SyntheticCE:
    q_emb: torch.Tensor       # (n_queries, d)
    i_emb: torch.Tensor       # (n_items, d)
    mix_a: torch.Tensor       # (R, d, r_low)
    mix_b: torch.Tensor       # (R, d, r_low)
    mix_w: torch.Tensor       # (R,)
    gamma: float
    sigma: float

    @property
    def n_queries(self) -> int:
        return self.q_emb.shape[0]

    @property
    def n_items(self) -> int:
        return self.i_emb.shape[0]

    @property
    def device(self) -> torch.device:
        return self.q_emb.device

    def to(self, device) -> "SyntheticCE":
        t = lambda x: x.to(device)
        return SyntheticCE(t(self.q_emb), t(self.i_emb), t(self.mix_a),
                           t(self.mix_b), t(self.mix_w), self.gamma, self.sigma)

    def _proj(self, e, mix):
        # (..., d) x (R, d, r) -> (..., R, r)
        return torch.tanh(torch.einsum("...d,rdk->...rk", e, mix))

    def _spike(self, d2):
        return self.gamma * torch.exp(-d2 / (2.0 * self.sigma ** 2))

    def score_pairs(self, query_ids, item_ids) -> torch.Tensor:
        """Exact CE scores for (B,) query ids x (B, k) item ids -> (B, k)."""
        qe = self.q_emb[query_ids.long()][:, None, :]         # (B, 1, d)
        ie = self.i_emb[item_ids.long()]                       # (B, k, d)
        bg = torch.einsum("...rk,...rk,r->...", self._proj(qe, self.mix_a),
                          self._proj(ie, self.mix_b), self.mix_w)
        return bg + self._spike(((qe - ie) ** 2).sum(-1))

    def score_block(self, query_ids, item_ids) -> torch.Tensor:
        """Bulk scores for (Q,) query ids x (N,) item ids -> (Q, N)."""
        qe = self.q_emb[query_ids.long()]                     # (Q, d)
        q, d = qe.shape
        qa = (self._proj(qe, self.mix_a) * self.mix_w[:, None]).reshape(q, -1)
        item_ids = item_ids.long()
        out = torch.empty((q, item_ids.shape[0]), dtype=torch.float32, device=qe.device)
        step = max(1, _CHUNK_ELEMS // max(1, q * d))
        for lo in range(0, item_ids.shape[0], step):
            ie = self.i_emb[item_ids[lo:lo + step]]            # (n, d)
            ib = self._proj(ie, self.mix_b).reshape(ie.shape[0], -1)
            d2 = ((qe[:, None, :] - ie[None, :, :]) ** 2).sum(-1)
            out[:, lo:lo + step] = qa @ ib.T + self._spike(d2)
        return out

    def full_matrix(self, query_ids, chunk: int = 128) -> torch.Tensor:
        """(Q, N) exact score matrix, computed in row chunks."""
        items = torch.arange(self.n_items, device=self.device)
        return torch.cat([self.score_block(query_ids[lo:lo + chunk], items)
                          for lo in range(0, query_ids.shape[0], chunk)])


def make_synthetic_ce(key, n_queries: int = 1000, n_items: int = 10000,
                      d: int = 16, r_low: int = 8, n_mix: int = 4,
                      gamma: float = 2.5, sigma: float = 0.6,
                      n_clusters: int = 25, device=None) -> SyntheticCE:
    """A synthetic domain with cluster structure, drawn from the port's own
    threefry (the reference's construction; the draws are not bit-equal to
    JAX's normal/randint — tests carry JAX-built domains across instead)."""
    dev = resolve_device(device)
    ks = prng.split(key, 6)
    s = d ** 0.5
    centers = prng.normal(ks[0], (n_clusters, d), dev) / s
    i_cluster = prng.randint(ks[1], (n_items,), 0, n_clusters, dev)
    i_emb = centers[i_cluster] + 0.3 * prng.normal(ks[2], (n_items, d), dev) / s
    q_cluster = prng.randint(ks[3], (n_queries,), 0, n_clusters, dev)
    q_emb = centers[q_cluster] + 0.3 * prng.normal(ks[4], (n_queries, d), dev) / s
    mk = prng.split(ks[5], 3)
    mix_a = prng.normal(mk[0], (n_mix, d, r_low), dev) / s
    mix_b = prng.normal(mk[1], (n_mix, d, r_low), dev) / s
    mix_w = prng.normal(mk[2], (n_mix,), dev).abs() + 0.5
    return SyntheticCE(q_emb, i_emb, mix_a, mix_b, mix_w, gamma, sigma)
