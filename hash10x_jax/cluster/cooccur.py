"""Batched per-barcode molecule clustering as 0/1 matrix products.

The device replacement for the reference's serial graph walk
(``hash10x.c:~codeClusterFind``, SURVEY.md §3.1 #8, §4.2): the per-barcode tally of
shared-barcode support becomes a batched 0/1 matmul, and serial union-find becomes a
deterministic min-label propagation fixpoint whose canonical relabeling provably
equals the oracle's union-find order (first-appearing k-mer numbers the cluster —
``oracle/cluster_ref.py``).

Pipeline per barcode batch (all static shapes, jit once per size class):

1. gather each k-mer's barcode list          -> CL (B, K, C) int32, -1 padded
2. local code universe by row sort + rank    -> ranks (B, K*C) in [0, U)
3. 0/1 indicator via scatter                 -> D (B, K, U) bf16
4. support S = D @ D^T                       -> (B, K, K) f32 (matrix units)
5. link iff S - 1 >= min_share               -> adjacency
6. min-label propagation to fixpoint         -> component = min k-mer index
7. dense-rank labels                         -> canonical cluster ids

Barcodes are bucketed by k-mer-set size into power-of-two classes so each class
compiles once (SURVEY.md §8.3: ragged structures -> padded size-class batches).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..table.incidence import Incidence

__all__ = ["cluster_batch", "cluster_codes"]

_INT_MAX = np.int32(2**31 - 1)


@functools.partial(jax.jit, static_argnames=("min_share",))
def cluster_batch(cl: jnp.ndarray, kmer_valid: jnp.ndarray, min_share: int = 2
                  ) -> jnp.ndarray:
    """Cluster one padded batch.

    cl: (B, K, C) int32 — sorted barcode ids per k-mer, -1 padding.
    kmer_valid: (B, K) bool — which k-mer rows are real.
    Returns canonical cluster labels (B, K) int32 (pad rows get -1).
    """
    B, K, C = cl.shape
    U = K * C

    # ---- local code universe: rank each entry among the row's distinct codes ----
    flat = cl.reshape(B, U)
    pad = flat < 0
    flat_s = jnp.where(pad, _INT_MAX, flat)
    srt = jnp.sort(flat_s, axis=1)
    # rank = index of first occurrence in sorted order (distinct codes get distinct
    # ranks; duplicates share one)
    ranks = jax.vmap(jnp.searchsorted)(srt, flat_s)              # (B, U) in [0, U)

    # ---- 0/1 indicator D[b, k, u] = k-mer k's list contains the u-th local code ---
    d = jnp.zeros((B, K, U), jnp.bfloat16)
    b_idx = jax.lax.broadcasted_iota(jnp.int32, (B, K, C), 0)
    k_idx = jax.lax.broadcasted_iota(jnp.int32, (B, K, C), 1)
    r_idx = ranks.reshape(B, K, C)
    d = d.at[b_idx, k_idx, r_idx].max(jnp.where(pad.reshape(B, K, C), 0, 1)
                                      .astype(jnp.bfloat16))

    # ---- support matmul (0/1 values: exact in bf16 x bf16 -> f32 up to 2^24) ----
    s = jnp.einsum("bku,blu->bkl", d, d, preferred_element_type=jnp.float32)

    # ---- adjacency: both lists always contain this barcode, so other-shared =
    #      support - 1 (oracle/cluster_ref.py contract) ----
    both_valid = kmer_valid[:, :, None] & kmer_valid[:, None, :]
    adj = (s - 1.0 >= min_share) & both_valid
    eye = jnp.eye(K, dtype=bool)[None]
    adj = adj | (eye & kmer_valid[:, :, None])

    # ---- min-label propagation to fixpoint: label = min k-mer index reachable ----
    init = jnp.where(kmer_valid, jax.lax.broadcasted_iota(jnp.int32, (B, K), 1), K)

    def cond(state):
        lab, changed = state
        return changed

    def body(state):
        lab, _ = state
        nbr_min = jnp.min(jnp.where(adj, lab[:, None, :], K), axis=2)
        new = jnp.minimum(lab, nbr_min)
        return (new, jnp.any(new != lab))

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))

    # ---- canonical dense rank: component roots appear in ascending index order,
    #      so rank(label among distinct labels) == first-appearance numbering ----
    lab_s = jnp.sort(jnp.where(kmer_valid, labels, _INT_MAX), axis=1)
    is_first = jnp.concatenate(
        [jnp.ones((B, 1), bool), lab_s[:, 1:] != lab_s[:, :-1]], axis=1)
    is_first = is_first & (lab_s != _INT_MAX)
    # canonical[i] = number of distinct labels strictly below labels[i]
    below = (lab_s[:, None, :] < labels[:, :, None]) & is_first[:, None, :]
    canon = jnp.sum(below, axis=2).astype(jnp.int32)
    return jnp.where(kmer_valid, canon, -1)


@functools.partial(jax.jit, static_argnames=("n_codes",))
def shares_batch(cl: jnp.ndarray, self_codes: jnp.ndarray, n_codes: int
                 ) -> jnp.ndarray:
    """One block of rows of the barcode x barcode co-occurrence matrix A·Aᵀ
    (BASELINE.json; oracle: ``barcode_shares``).

    cl: (B, K, C) int32 barcode lists of each barcode's k-mers (-1 pad).
    Returns share (B, n_codes) int32 with the diagonal (self) zeroed.
    """
    B = cl.shape[0]
    flat = cl.reshape(B, -1)
    ok = flat >= 0
    b_idx = jax.lax.broadcasted_iota(jnp.int32, flat.shape, 0)
    acc = jnp.zeros((B, n_codes), jnp.int32)
    acc = acc.at[b_idx, jnp.where(ok, flat, 0)].add(ok.astype(jnp.int32))
    return acc.at[jnp.arange(B), self_codes].set(0)


@jax.jit
def friend_union_batch(cl: jnp.ndarray, kmer_valid: jnp.ndarray,
                       friends: jnp.ndarray) -> jnp.ndarray:
    """Cluster one padded batch by friend-barcode bipartite components.

    cl: (B, K, C) int32 — *ascending* barcode lists per k-mer, -1 padding.
    friends: (B, F) int32 friend barcode ids, -1 padding.
    A k-mer and a friend connect iff the friend's id appears in the k-mer's list;
    connected components over the bipartite graph = molecules (oracle:
    ``cluster_barcode_friend``).  Returns canonical labels (B, K), pad rows -1.
    """
    B, K, C = cl.shape
    F = friends.shape[1]
    # membership via binary search (lists are sorted; pads pushed to +inf)
    clp = jnp.where(cl < 0, _INT_MAX, cl)
    fq = jnp.where(friends < 0, -2, friends)          # never matches
    idx = jax.vmap(lambda rows, q: jax.vmap(lambda r: jnp.searchsorted(r, q))(rows)
                   )(clp, fq)                          # (B, K, F)
    hit = jnp.take_along_axis(clp, jnp.minimum(idx, C - 1), axis=2)
    m = (hit == fq[:, None, :]) & kmer_valid[:, :, None]

    init = jnp.where(kmer_valid, jax.lax.broadcasted_iota(jnp.int32, (B, K), 1), K)

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        lab, _ = state
        colmin = jnp.min(jnp.where(m, lab[:, :, None], K), axis=1)      # (B, F)
        new = jnp.minimum(lab, jnp.min(jnp.where(m, colmin[:, None, :], K), axis=2))
        return (new, jnp.any(new != lab))

    labels, _ = jax.lax.while_loop(cond, body, (init, jnp.bool_(True)))

    lab_s = jnp.sort(jnp.where(kmer_valid, labels, _INT_MAX), axis=1)
    is_first = jnp.concatenate(
        [jnp.ones((B, 1), bool), lab_s[:, 1:] != lab_s[:, :-1]], axis=1)
    is_first = is_first & (lab_s != _INT_MAX)
    below = (lab_s[:, None, :] < labels[:, :, None]) & is_first[:, None, :]
    canon = jnp.sum(below, axis=2).astype(jnp.int32)
    return jnp.where(kmer_valid, canon, -1)


@functools.partial(jax.jit, static_argnames=("n_codes", "thr", "max_friends", "C"))
def _friend_pipeline(kmer_ids, kmer_valid, self_codes, csr_codes, csr_off,
                     csr_len, n_codes: int, thr: int, max_friends: int, C: int):
    """Fully device-resident friend clustering for one padded batch.

    kmer_ids (B, K) int32 (-1 pad); csr_* = device copies of the inverted
    incidence (codes-per-kmer lists).  Assembles CL by gather, computes barcode
    shares, extracts top-(thr, max_friends) friends with a packed-key top_k
    (ordering = (-share, smaller id), the ``cluster_barcode_friend`` rule), and
    label-propagates — only the (B, K) labels ever return to the host.
    """
    B, K = kmer_ids.shape
    kid = jnp.maximum(kmer_ids, 0)
    off = csr_off[kid]                                   # (B, K)
    ll = csr_len[kid]
    c_iota = jax.lax.broadcasted_iota(jnp.int32, (B, K, C), 2)
    ok = (c_iota < ll[:, :, None]) & (kmer_ids >= 0)[:, :, None]
    idx = jnp.minimum(off[:, :, None] + c_iota, csr_codes.shape[0] - 1)
    cl = jnp.where(ok, csr_codes[idx], -1)

    share = shares_batch(cl, self_codes, n_codes)        # (B, n_codes)
    iota_n = jax.lax.broadcasted_iota(jnp.int64, (B, n_codes), 1)
    key = share.astype(jnp.int64) * jnp.int64(n_codes) + (
        jnp.int64(n_codes - 1) - iota_n)
    topv, _ = jax.lax.top_k(key, min(max_friends, n_codes))
    top_share = (topv // jnp.int64(n_codes)).astype(jnp.int32)
    top_id = (jnp.int64(n_codes - 1) - (topv % jnp.int64(n_codes))).astype(jnp.int32)
    friends = jnp.where(top_share >= thr, top_id, -1)

    return friend_union_batch(cl, kmer_valid, friends)


def _size_class(n: int) -> int:
    c = 8
    while c < n:
        c *= 2
    return c



def cluster_codes(inc: Incidence, min_share: int = 2, mode: str = "friend",
                  min_friend_share: int = 8, max_friends: int = 256,
                  max_batch_bytes: int = 256 << 20, flat: bool = False):
    """Cluster every barcode of an Incidence (the ``--codeClusters`` pass).

    mode="pair": exact pairwise-support contract (O(K^2) per barcode — small sets).
    mode="friend": scalable friend-barcode path (near-linear; the co-occurrence
    matrix route of BASELINE.json).  Both bit-match their oracle counterparts.

    Returns per-code int32 label arrays aligned with ``inc.kmers_of(code)``
    order, or — with ``flat=True`` — one position-aligned flat int32 array
    (the at-scale representation: no O(n_codes) host objects).
    The uncapped friend path (max_friends=0, the default) runs the fully sparse
    global pipeline (``cluster/sparse.py`` — memory ∝ pairs, never n_codes²);
    capped friend and pair modes run as padded per-barcode device batches grouped
    into power-of-two (K, C) size classes.
    """
    if mode == "friend" and max_friends == 0:
        from .sparse import cluster_codes_sparse
        return cluster_codes_sparse(inc, min_friend_share=min_friend_share,
                                    flat=flat)
    sizes = np.diff(inc.code_offsets)
    list_lens = np.diff(inc.kmer_offsets)
    # labels accumulate into ONE flat position-aligned array (vectorized
    # scatter per batch); the per-code list view materializes only for
    # flat=False — a per-code Python loop was O(n_codes) host work and
    # crawled at 1M codes (r03 advisor finding)
    flat_out = np.full(inc.n_pairs, -1, np.int32)

    order = np.argsort(sizes, kind="stable")
    active = order[sizes[order] > 0]
    if len(active) == 0:
        if flat:
            return flat_out[:0] if inc.n_pairs == 0 else flat_out
        return [np.zeros(0, np.int32)] * inc.n_codes

    classes: dict = {}
    for code in active:
        kc = _size_class(int(sizes[code]))
        classes.setdefault(kc, []).append(int(code))

    if mode == "friend":
        # device-resident inverted CSR (gathered on device per batch)
        csr_codes = jnp.asarray(inc.kmer_codes, jnp.int32)
        csr_off = jnp.asarray(inc.kmer_offsets[:-1], jnp.int32)
        csr_len = jnp.asarray(list_lens, jnp.int32)

    for kc, codes_in_class in sorted(classes.items()):
        cmax = 1
        for code in codes_in_class:
            ks = inc.kmers_of(code)
            if len(ks):
                cmax = max(cmax, int(list_lens[ks].max()))
        cc = _size_class(cmax)
        # per-row working set (int32 cells): pair mode materializes the one-hot
        # (K, K*C); friend mode holds CL (K,C) + a share row (n_codes) + the
        # membership/label tensors (K*F)
        if mode == "pair":
            per_row = kc * kc * cc
        else:
            per_row = kc * cc + inc.n_codes + kc * max(max_friends, 64)
        bsz = max(1, max_batch_bytes // (4 * max(per_row, 1)))
        for i in range(0, len(codes_in_class), bsz):
            chunk = codes_in_class[i:i + bsz]
            B = len(chunk)
            chunk_arr = np.asarray(chunk)
            ks_counts = sizes[chunk_arr]
            bi_of_k = np.repeat(np.arange(B), ks_counts)
            ki_of_k = np.arange(int(ks_counts.sum())) - np.repeat(
                np.cumsum(ks_counts) - ks_counts, ks_counts)
            # vectorized gather of the chunk's kmer ids (a per-code list
            # comprehension here was O(n_codes) Python work at scale)
            pos_flat = np.repeat(inc.code_offsets[chunk_arr],
                                 ks_counts) + ki_of_k
            kmer_flat = inc.code_kmers[pos_flat].astype(np.int64)
            if mode == "friend":
                # assemble only the (B, K) kmer-id matrix on host; CL is
                # gathered on device (the (B, K, C) host transfer dominated
                # cluster wall time at 50k barcodes)
                km = np.full((B, kc), -1, np.int32)
                km[bi_of_k, ki_of_k] = kmer_flat.astype(np.int32)
                valid = km >= 0
                labels = np.asarray(_friend_pipeline(
                    km, valid, chunk_arr.astype(np.int32), csr_codes,
                    csr_off, csr_len, n_codes=inc.n_codes,
                    thr=min_friend_share, max_friends=max_friends, C=cc))
            elif mode == "pair":
                cl = np.full((B, kc, cc), -1, np.int32)
                valid = np.zeros((B, kc), bool)
                valid[bi_of_k, ki_of_k] = True
                ll = list_lens[kmer_flat]
                total = int(ll.sum())
                row_of = np.repeat(np.arange(len(kmer_flat)), ll)
                col_of = np.arange(total) - np.repeat(np.cumsum(ll) - ll, ll)
                src = inc.kmer_codes[np.repeat(inc.kmer_offsets[kmer_flat], ll)
                                     + col_of]
                cl[bi_of_k[row_of], ki_of_k[row_of], col_of] = src
                labels = np.asarray(cluster_batch(cl, valid, min_share))
            else:
                raise ValueError(f"unknown cluster mode {mode!r}")
            # vectorized scatter into the flat position-aligned array
            flat_out[pos_flat] = labels[bi_of_k, ki_of_k]
    if flat:
        return flat_out
    return [flat_out[inc.code_offsets[c]:inc.code_offsets[c + 1]]
            for c in range(inc.n_codes)]
