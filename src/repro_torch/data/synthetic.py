"""Synthetic ZESHEL-like cross-encoder domains — port of
``SyntheticCE``/``make_synthetic_ce``, ``lexical_signatures`` and
``ZeshelLikeDataset``/``make_zeshel_like`` from ``repro/data/synthetic.py``.

    score(q, i) = sum_r w_r · <tanh(A_r e_q), tanh(B_r e_i)>     (background)
                + gamma · exp(-||e_q - e_i||² / (2σ²))           (k-NN spikes)

Bulk scoring is chunked over items so no temporary grows past a few
hundred MB (the serving domain has 10^6 items); the background of a block
is one (Q, R·r) x (R·r, N) fp32 matrix product.  ``score_pairs`` (what a
search scores) contracts with products and fixed-order sums of slices
instead, so a pair's bits do not depend on how many rows share its call
(on the card a GEMM or a reduction kernel picks its algorithm by shape).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
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
        # (..., d) x (R, d, r) -> (..., R, r) as one GEMM (the bulk path)
        return torch.tanh(torch.einsum("...d,rdk->...rk", e, mix))

    def _proj_rows(self, e, mix):
        # (..., d) x (R, d, r) -> (..., R, r): a product and a fixed-order sum
        # over d, element by element
        return torch.tanh(_tree_sum(e[..., None, None, :] * mix.transpose(1, 2)))

    def _spike(self, d2):
        return self.gamma * torch.exp(-d2 / (2.0 * self.sigma ** 2))

    def score_pairs(self, query_ids, item_ids) -> torch.Tensor:
        """Exact CE scores for (B,) query ids x (B, k) item ids -> (B, k).
        Elementwise kernels and sums of slices only: a row's bits do not
        depend on its batch (``tests/test_torch_cuda.py`` holds it on the
        card)."""
        qe = self.q_emb[query_ids.long()][:, None, :]         # (B, 1, d)
        ie = self.i_emb[item_ids.long()]                       # (B, k, d)
        terms = (self._proj_rows(qe, self.mix_a) * self._proj_rows(ie, self.mix_b)
                 * self.mix_w[:, None])                        # (B, k, R, r)
        bg = _tree_sum(terms.flatten(-2))
        return bg + self._spike(_tree_sum((qe - ie) ** 2))

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


def _tree_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum over the last axis by halving: each step adds the upper half
    of the remaining slices onto the lower, an elementwise add, so every
    output's order of additions is fixed by the axis' length alone."""
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        head = x[..., :h] + x[..., h:2 * h]
        x = torch.cat([head, x[..., 2 * h:]], dim=-1) if x.shape[-1] % 2 else head
    return x[..., 0]


def make_synthetic_ce(key, n_queries: int = 1000, n_items: int = 10000,
                      d: int = 16, r_low: int = 8, n_mix: int = 4,
                      gamma: float = 2.5, sigma: float = 0.6,
                      n_clusters: int = 25, device=None) -> SyntheticCE:
    """A synthetic domain with cluster structure: the reference's
    construction from the same key.  ``prng.randint`` draws JAX's cluster
    ids bit for bit and ``prng.normal`` JAX's normals bit for bit outside
    their far tail (a few ulp there; ``core/prng.py``), so
    ``make_synthetic_ce(prng.PRNGKey(s), ...)`` is the reference's
    ``make_synthetic_ce(jax.random.PRNGKey(s), ...)`` up to those ulp."""
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


# ---------------------------------------------------------------------------
# ZESHEL-like token datasets for the transformer cross-encoder (numpy only,
# so the tokens are bit-equal to the reference's for the same seed)
# ---------------------------------------------------------------------------

PAD, CLS, SEP, MASK = 0, 1, 2, 3
N_SPECIAL = 4


def lexical_signatures(emb, n_terms: int = 8, n_planes: int = 64, seed: int = 0) -> np.ndarray:
    """Signed random-projection "tokens" for an embedding-only corpus (the
    synthetic domain has no text; BM25 needs token sequences): each row's
    ``n_terms`` largest-|projection| planes of ``n_planes`` shared random
    hyperplanes, sign-split (plane p firing positive and negative are
    different tokens), a vocabulary of ``2 * n_planes`` tokens plus the pad
    id 0.  Numpy's ``default_rng(seed)`` on the host, as the reference, so
    the same embeddings give the same tokens; corpus and queries must share
    ``seed``."""
    if isinstance(emb, torch.Tensor):
        emb = emb.detach().cpu().numpy()
    emb = np.asarray(emb, dtype=np.float32)
    rng = np.random.default_rng(seed)
    planes = rng.standard_normal((emb.shape[1], n_planes)).astype(np.float32)
    proj = emb @ planes                                   # (B, n_planes)
    top = np.argsort(-np.abs(proj), axis=1, kind="stable")[:, :n_terms]
    sign = (np.take_along_axis(proj, top, axis=1) >= 0).astype(np.int32)
    return (2 * top + sign + 1).astype(np.int32)          # 0 stays the pad id


@dataclass
class ZeshelLikeDataset:
    """Token-level entity-linking data: items are 'entity descriptions'
    (random-but-consistent token sequences), queries are 'mentions' (noisy
    crops of their gold entity's description)."""

    item_tokens: np.ndarray     # (n_items, item_len) int32
    query_tokens: np.ndarray    # (n_queries, query_len) int32
    gold: np.ndarray            # (n_queries,) gold item id
    vocab_size: int
    item_len: int
    query_len: int

    def pair_tokens(self, query_ids: np.ndarray, item_ids: np.ndarray) -> np.ndarray:
        """``[CLS] query [SEP] item [SEP]``: query_ids (B,), item_ids (B, K)
        -> (B, K, L) int32 tokens."""
        q = self.query_tokens[query_ids]                       # (B, Lq)
        it = self.item_tokens[item_ids]                        # (B, K, Li)
        b, k = item_ids.shape
        lq, li = q.shape[1], it.shape[2]
        out = np.zeros((b, k, lq + li + 3), dtype=np.int32)
        out[:, :, 0] = CLS
        out[:, :, 1: 1 + lq] = q[:, None, :]
        out[:, :, 1 + lq] = SEP
        out[:, :, 2 + lq: 2 + lq + li] = it
        out[:, :, 2 + lq + li] = SEP
        return out


def make_zeshel_like(seed: int, n_items: int = 2000, n_queries: int = 400,
                     vocab: int = 256, item_len: int = 24, query_len: int = 16,
                     n_families: int = 40,
                     family_overlap: float = 0.6) -> ZeshelLikeDataset:
    """Entity families share ``family_overlap`` of their tokens, creating the
    confusable near-neighbour structure zero-shot entity linking has."""
    rng = np.random.default_rng(seed)
    usable = vocab - N_SPECIAL
    fam_proto = rng.integers(0, usable, size=(n_families, item_len)) + N_SPECIAL
    fam_of_item = rng.integers(0, n_families, size=n_items)
    item_tokens = fam_proto[fam_of_item].copy()
    keep = rng.random((n_items, item_len)) < family_overlap
    uniq = rng.integers(0, usable, size=(n_items, item_len)) + N_SPECIAL
    item_tokens = np.where(keep, item_tokens, uniq).astype(np.int32)

    gold = rng.integers(0, n_items, size=n_queries)
    starts = rng.integers(0, item_len - query_len + 1, size=n_queries)
    query_tokens = np.stack(
        [item_tokens[g, s: s + query_len] for g, s in zip(gold, starts)]
    )
    noise = rng.random((n_queries, query_len)) < 0.15
    rand_tok = rng.integers(0, usable, size=(n_queries, query_len)) + N_SPECIAL
    query_tokens = np.where(noise, rand_tok, query_tokens).astype(np.int32)
    return ZeshelLikeDataset(item_tokens, query_tokens, gold.astype(np.int32),
                             vocab, item_len, query_len)
