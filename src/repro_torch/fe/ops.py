"""Feature-extraction operator library (paper §III "Extract features").

Every new engineered feature is an operator over the joined structured table.
Device ops are PyTorch functions on tensors of one device (the FE device
super-layer runs them eagerly, the hash/cross ops through the
``feature_hash`` kernel); host ops handle strings and stay numpy. The
integer mixing hash is shared by the numpy host ops, these torch ops and the
kernel's plain version, so all agree bit for bit with the JAX package.

All hashes land in a fixed feature space of ``2**bits`` slots per field; the
sparse id convention is ``field_offset + (hash % field_size)``.

32-bit unsigned arithmetic in torch: ``torch.uint32`` lacks the ops, and
``>>`` on int32 is an arithmetic shift, so the torch twins hold uint32
values in int64 tensors masked to the low 32 bits, and split each 32-bit
multiply so no int64 product overflows.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.fe.colstore import RaggedColumn

# ----------------------------------------------------------------- hashing
# Finalizer of MurmurHash3 (fmix32): mul/xor/shift only, 32-bit arithmetic.
_C1 = np.uint32(0x85EBCA6B)
_C2 = np.uint32(0xC2B2AE35)
_GOLDEN = np.uint32(0x9E3779B9)
_MASK32 = 0xFFFFFFFF


def fmix32_np(x: np.ndarray) -> np.ndarray:
    """MurmurHash3 32-bit finalizer on uint32 numpy arrays (host ops)."""
    with np.errstate(over="ignore"):
        x = np.asarray(x).astype(np.uint32)
        x = x ^ (x >> np.uint32(16))
        x = x * _C1
        x = x ^ (x >> np.uint32(13))
        x = x * _C2
        x = x ^ (x >> np.uint32(16))
        return x


def hash_combine_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    with np.errstate(over="ignore"):
        a = np.asarray(a).astype(np.uint32)
        b = np.asarray(b).astype(np.uint32)
        return fmix32_np(a * _GOLDEN + fmix32_np(b))


def as_uint32(x: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of an integer tensor, read as unsigned, in int64."""
    return x.to(torch.int64) & _MASK32


def narrow_int32(x: torch.Tensor) -> torch.Tensor:
    """Narrow an integer tensor to int32 by keeping its low 32 bits, read as
    signed (what the JAX plan's jit does to int64 columns with x64 off).
    Written out in int64 so it never relies on an overflowing cast."""
    if x.dtype == torch.int32:
        return x
    return (((x.to(torch.int64) & _MASK32) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for x in [0, 2**32): two 16-bit halves of ``c``
    keep every int64 product below 2**48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """MurmurHash3 32-bit finalizer; returns uint32 values in int64."""
    x = as_uint32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, int(_C1))
    x = x ^ (x >> 13)
    x = _mul32(x, int(_C2))
    x = x ^ (x >> 16)
    return x


def hash_combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Order-sensitive combine of two id columns; uint32 values in int64."""
    return fmix32((_mul32(as_uint32(a), int(_GOLDEN)) + fmix32(b)) & _MASK32)


# ----------------------------------------------------------- device FE ops
def cross_feature(a: torch.Tensor, b: torch.Tensor, *, field_size: int) -> torch.Tensor:
    """Feature combination: cross two categorical columns into one id."""
    return (hash_combine(a, b) % field_size).to(torch.int32)


def bucketize(x: torch.Tensor, boundaries: Sequence[float]) -> torch.Tensor:
    """Discretize a float column into integer buckets (right-open)."""
    b = torch.tensor(list(boundaries), dtype=torch.float32, device=x.device)
    return torch.searchsorted(b, x.to(torch.float32), right=True).to(torch.int32)


def log_norm(x: torch.Tensor) -> torch.Tensor:
    """log(1+x) transform used for Criteo-style dense counters."""
    return torch.log1p(torch.clamp_min(x.to(torch.float32), 0.0))


def sparse_id(hashed: torch.Tensor, *, field_index: int, field_size: int) -> torch.Tensor:
    """Map a per-field hash into the global sparse id space (int32 floor-mod)."""
    return (torch.remainder(narrow_int32(hashed), field_size)
            + field_index * field_size)


def clip_seq(ids: torch.Tensor, *, max_len: int, pad_id: int = 0) -> torch.Tensor:
    """Truncate/pad a dense [B, L] id matrix to max_len (behavior sequences)."""
    b, l = ids.shape
    if l >= max_len:
        return ids[:, :max_len]
    pad = torch.full((b, max_len - l), pad_id, dtype=ids.dtype, device=ids.device)
    return torch.cat([ids, pad], dim=1)


# ------------------------------------------------------------- host FE ops
#
# Host string ops are the FE hot path's CPU tax: they run once per batch on
# the critical path of the read+extract stage. Both ops below are
# numpy-vectorized single-pass implementations; the per-row loop versions
# are kept as ``*_ref`` oracles (the semantic spec, exercised bit-for-bit
# by hypothesis tests).
#
# Token hashing is deterministic across processes and hosts: token ids are
# derived ONLY from token bytes via :func:`fmix32_np` chains (the builtin
# ``hash()`` is salted per process by PYTHONHASHSEED, so two hosts of one
# training job would disagree on every feature id). The hash spec:
#
# * token hash: ``h = uint32(n_codepoints)``, then for each codepoint
#   ``cp`` (one uint32 word of the token's UTF-32-LE bytes)
#   ``h = fmix32(h * GOLDEN + cp)``;
# * n-gram id: ``g = uint32(n)``, then for each member token hash ``th``
#   (left to right) ``g = fmix32(g * GOLDEN + th)``; id = ``g % field_size``.
#
# Tokenization splits on Unicode whitespace exactly like ``str.split()``;
# NUL (U+0000) is additionally treated as a separator so the fixed-width
# numpy codepoint matrix (NUL-padded) and Python strings agree.

# The codepoints ``str.split()`` treats as whitespace (CPython's
# Py_UNICODE_ISSPACE table: Unicode White_Space plus the 0x1C-0x1F file/
# group/record/unit separators). Verified against ``chr(c).isspace()``
# over the full codepoint range in tests/test_hostops.py.
_WHITESPACE_CODEPOINTS = np.asarray(
    [0x09, 0x0A, 0x0B, 0x0C, 0x0D, 0x1C, 0x1D, 0x1E, 0x1F, 0x20, 0x85,
     0xA0, 0x1680, 0x2000, 0x2001, 0x2002, 0x2003, 0x2004, 0x2005, 0x2006,
     0x2007, 0x2008, 0x2009, 0x200A, 0x2028, 0x2029, 0x202F, 0x205F,
     0x3000],
    np.uint32,
)


def _token_hash_ref(token: str) -> int:
    """Oracle token hash: fmix32 chain over the token's UTF-32-LE words."""
    cps = np.frombuffer(token.encode("utf-32-le"), "<u4").astype(np.uint32)
    with np.errstate(over="ignore"):
        h = np.uint32(len(cps))
        for cp in cps:
            h = fmix32_np(h * _GOLDEN + cp)
    return int(h)


def _gram_hash_ref(token_hashes: Sequence[int], n: int) -> int:
    """Oracle n-gram hash: fmix32 chain over the member token hashes."""
    with np.errstate(over="ignore"):
        g = np.uint32(n)
        for th in token_hashes:
            g = fmix32_np(g * _GOLDEN + np.uint32(th))
    return int(g)


def tokenize_hash_ref(strings: np.ndarray, *, field_size: int,
                      ngrams: int = 1) -> RaggedColumn:
    """Per-row loop reference for :func:`tokenize_hash` (the semantic spec).

    Kept as the oracle the vectorized implementation is property-tested
    against, and as the baseline the host-op benchmark measures speedup
    over.
    """
    values: List[int] = []
    lengths: List[int] = []
    for s in strings:
        toks = str(s).replace("\x00", " ").split()
        tok_hashes = [_token_hash_ref(t) for t in toks]
        ids = [
            _gram_hash_ref(tok_hashes[i: i + n], n) % field_size
            for n in range(1, ngrams + 1)
            for i in range(len(toks) - n + 1)
        ]
        values.extend(ids)
        lengths.append(len(ids))
    return RaggedColumn(
        values=np.asarray(values, np.int64), lengths=np.asarray(lengths, np.int32)
    )


def _token_spans(codes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Token (start, length, row) triples from a [B, L+1] codepoint matrix.

    The matrix's trailing column must be a separator (0) so token runs never
    cross row boundaries. One vectorized pass: separator mask -> run starts/
    ends via shifted comparisons.
    """
    b, lp1 = codes.shape
    sep = np.isin(codes, _WHITESPACE_CODEPOINTS) | (codes == np.uint32(0))
    tok = ~sep.ravel()
    prev = np.empty_like(tok)
    prev[0] = False
    prev[1:] = tok[:-1]
    starts = np.flatnonzero(tok & ~prev)
    nxt = np.empty_like(tok)
    nxt[-1] = False
    nxt[:-1] = tok[1:]
    ends = np.flatnonzero(tok & ~nxt)
    lens = ends - starts + 1
    rows = starts // lp1
    return starts, lens, rows


def _hash_tokens(flat_codes: np.ndarray, starts: np.ndarray,
                 lens: np.ndarray) -> np.ndarray:
    """Vectorized fmix32 chain over every token's codepoints.

    Column-at-a-time over the longest token: iteration j advances the hash
    of every token still longer than j positions — O(max_token_len) passes
    of bulk vector work instead of a Python loop per token.
    """
    with np.errstate(over="ignore"):
        h = lens.astype(np.uint32)
        alive = np.arange(starts.shape[0])
        for j in range(int(lens.max()) if lens.size else 0):
            alive = alive[lens[alive] > j]
            if not alive.size:
                break
            cps = flat_codes[starts[alive] + j]
            h[alive] = fmix32_np(h[alive] * _GOLDEN + cps)
    return h


def tokenize_hash(strings: np.ndarray, *, field_size: int, ngrams: int = 1) -> RaggedColumn:
    """Keyword extraction: split on whitespace, hash (n-gram) tokens.

    This is the paper's "extract keywords with language models" stand-in: a
    host (string) op producing a ragged int column whose per-row lengths vary
    — the workload class Alg. 1's allocator exists for.

    Vectorized: strings are bulk-converted to a fixed-width codepoint
    matrix, tokenized with one separator-mask pass, hashed column-at-a-time
    (fmix32 chains), and n-gram ids scattered into the output with fancy
    indexing — no per-row Python loop. Bit-identical to
    :func:`tokenize_hash_ref`.
    """
    arr = np.asarray(strings)
    b = int(arr.shape[0])
    empty = RaggedColumn(values=np.zeros((0,), np.int64),
                         lengths=np.zeros((b,), np.int32))
    if b == 0:
        return empty
    if arr.dtype.kind == "U":
        u = arr
    elif arr.dtype.kind in "OS":
        # exact ref semantics: every row through ``str()`` (bytes rows give
        # their "b'...'" repr). numpy's astype(np.str_) would DECODE bytes
        # instead. This normalization is the only per-row Python step; the
        # tokenizer and hashing below stay fully vectorized.
        u = np.asarray([str(x) for x in arr.tolist()], np.str_)
    else:
        u = arr.astype(np.str_)
    width = u.dtype.itemsize // 4
    if width == 0:  # every row is the empty string
        return empty
    # [B, L+1] codepoint matrix; the appended 0 column terminates row runs.
    codes = np.zeros((b, width + 1), np.uint32)
    codes[:, :width] = np.ascontiguousarray(u).view(np.uint32).reshape(b, width)
    starts, tok_lens, tok_rows = _token_spans(codes)
    flat = codes.ravel()
    tok_hashes = _hash_tokens(flat, starts, tok_lens)

    n_tokens = np.bincount(tok_rows, minlength=b)           # tokens per row
    tok_row_start = np.concatenate([[0], np.cumsum(n_tokens)[:-1]])
    # Output ordering (matches the ref): per row, all 1-grams, then all
    # 2-grams, ... Per-row gram counts c_n = max(n_tokens - n + 1, 0).
    gram_counts = [np.maximum(n_tokens - n + 1, 0)
                   for n in range(1, ngrams + 1)]
    lengths = np.sum(gram_counts, axis=0).astype(np.int32)
    row_out_start = np.concatenate([[0], np.cumsum(lengths)[:-1]]).astype(np.int64)
    values = np.zeros((int(lengths.sum()),), np.int64)

    t = starts.shape[0]
    block_start = row_out_start.copy()  # start of the current n-gram block
    with np.errstate(over="ignore"):
        for n in range(1, ngrams + 1):
            w = t - n + 1
            if w > 0:
                g = np.full((w,), np.uint32(n))
                for k in range(n):
                    g = fmix32_np(g * _GOLDEN + tok_hashes[k: k + w])
                # window [i, i+n) is a gram iff it stays within one row
                valid = tok_rows[:w] == tok_rows[n - 1: n - 1 + w]
                idx = np.flatnonzero(valid)
                rows = tok_rows[idx]
                pos_in_row = idx - tok_row_start[rows]
                values[block_start[rows] + pos_in_row] = \
                    (g[idx] % np.uint32(field_size)).astype(np.int64)
            block_start += gram_counts[n - 1]
    return RaggedColumn(values=values, lengths=lengths)


def ragged_to_padded_ref(col: RaggedColumn, *, max_len: int,
                         pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Per-row loop reference for :func:`ragged_to_padded` (the oracle)."""
    b = col.n_rows
    out = np.full((b, max_len), pad_id, np.int64)
    mask = np.zeros((b, max_len), np.float32)
    offs = col.offsets()
    for i in range(b):
        n = min(int(col.lengths[i]), max_len)
        out[i, :n] = col.values[offs[i]: offs[i] + n]
        mask[i, :n] = 1.0
    return out, mask


def ragged_to_padded(col: RaggedColumn, *, max_len: int, pad_id: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Densify a ragged column into [B, max_len] + mask for device consumption.

    Vectorized single-pass scatter: row/column/source indices for every kept
    element come from ``offsets()`` + prefix sums, then one fancy-indexed
    assignment fills ids and mask. Bit-identical to
    :func:`ragged_to_padded_ref`.
    """
    b = col.n_rows
    out = np.full((b, max_len), pad_id, np.int64)
    mask = np.zeros((b, max_len), np.float32)
    if b == 0 or max_len == 0:
        return out, mask
    keep = np.minimum(col.lengths.astype(np.int64), max_len)
    total = int(keep.sum())
    if total == 0:
        return out, mask
    rows = np.repeat(np.arange(b), keep)
    within = np.arange(total) - np.repeat(np.cumsum(keep) - keep, keep)
    src = np.repeat(col.offsets(), keep) + within
    out[rows, within] = col.values[src]
    mask[rows, within] = 1.0
    return out, mask


def ragged_to_bag(col: RaggedColumn) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged column -> (flat ids, segment ids) for EmbeddingBag lookup."""
    segs = np.repeat(np.arange(col.n_rows, dtype=np.int32), col.lengths)
    return col.values.astype(np.int64), segs
