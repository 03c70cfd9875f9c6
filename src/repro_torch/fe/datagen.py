"""Synthetic raw ads-log generator (stand-in for the paper's 15–25 TB logs).

Generates the three view sources of a typical ads pipeline plus the
materialized *basic features* table, with realistic messiness: null
sentinels, JSON context payloads, ragged interest lists, free-text titles.
Scaled down (10^4–10^6 instances) but structurally identical, so every
pipeline stage (read -> clean -> join -> extract -> merge) is exercised.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch.fe.colstore import ColumnStore, Columns, RaggedColumn
from repro_torch.fe.schema import ColType, Column, ViewSchema

_NULL_INT = np.iinfo(np.int64).min
_NULL_FLOAT = np.nan

WORDS = (
    "cheap flights hotel deals shoes running phone case laptop gaming credit "
    "card insurance auto home loan pizza delivery coffee near me best price"
).split()


IMPRESSIONS = ViewSchema(
    name="impressions",
    key="instance_id",
    columns=(
        Column("instance_id", ColType.INT, nullable=False),
        Column("user_id", ColType.INT, nullable=False),
        Column("ad_id", ColType.INT, nullable=False),
        Column("label", ColType.INT, nullable=False),
        Column("hour", ColType.INT),
        Column("dwell_time", ColType.FLOAT),
        Column("context_json", ColType.STRING),
    ),
)

USER_PROFILE = ViewSchema(
    name="user_profile",
    key="user_id",
    columns=(
        Column("user_id", ColType.INT, nullable=False),
        Column("age_bucket", ColType.INT),
        Column("gender", ColType.INT),
        Column("interests", ColType.INT_LIST),
        Column("query_text", ColType.STRING),
    ),
)

AD_INVENTORY = ViewSchema(
    name="ad_inventory",
    key="ad_id",
    columns=(
        Column("ad_id", ColType.INT, nullable=False),
        Column("advertiser_id", ColType.INT),
        Column("campaign_id", ColType.INT),
        Column("bid_price", ColType.FLOAT),
        Column("title_text", ColType.STRING),
    ),
)

BASIC_FEATURES = ViewSchema(
    name="basic_features",
    key="instance_id",
    columns=(
        Column("instance_id", ColType.INT, nullable=False),
        Column("ctr_7d", ColType.FLOAT),
        Column("user_click_cnt", ColType.FLOAT),
        Column("ad_show_cnt", ColType.FLOAT),
    ),
)


def _text(rng: np.random.Generator, n_words: int) -> str:
    return " ".join(rng.choice(WORDS, size=n_words))


def gen_views(
    n_instances: int,
    *,
    n_users: Optional[int] = None,
    n_ads: Optional[int] = None,
    null_rate: float = 0.05,
    seed: int = 0,
) -> Dict[str, Columns]:
    """Generate the raw views + basic features for ``n_instances`` logs."""
    rng = np.random.default_rng(seed)
    n_users = n_users or max(4, n_instances // 4)
    n_ads = n_ads or max(4, n_instances // 8)

    def nullify_int(col):
        mask = rng.random(col.shape) < null_rate
        return np.where(mask, _NULL_INT, col)

    def nullify_float(col):
        mask = rng.random(col.shape) < null_rate
        return np.where(mask, _NULL_FLOAT, col).astype(np.float32)

    user_ids = rng.integers(0, n_users, n_instances)
    ad_ids = rng.integers(0, n_ads, n_instances)
    ctx = np.array(
        [
            json.dumps({"slot": int(rng.integers(0, 16)),
                        "device": int(rng.integers(0, 4)),
                        "geo": int(rng.integers(0, 512))})
            if rng.random() > null_rate else ""
            for _ in range(n_instances)
        ],
        dtype=object,
    )
    impressions: Columns = {
        "instance_id": np.arange(n_instances, dtype=np.int64),
        "user_id": user_ids.astype(np.int64),
        "ad_id": ad_ids.astype(np.int64),
        "label": (rng.random(n_instances) < 0.05).astype(np.int64),
        "hour": nullify_int(rng.integers(0, 24, n_instances).astype(np.int64)),
        "dwell_time": nullify_float(rng.exponential(3.0, n_instances)),
        "context_json": ctx,
    }

    lengths = rng.integers(0, 8, n_users).astype(np.int32)
    interests = RaggedColumn(
        values=rng.integers(0, 10_000, int(lengths.sum())).astype(np.int64),
        lengths=lengths,
    )
    user_profile: Columns = {
        "user_id": np.arange(n_users, dtype=np.int64),
        "age_bucket": nullify_int(rng.integers(0, 10, n_users).astype(np.int64)),
        "gender": nullify_int(rng.integers(0, 3, n_users).astype(np.int64)),
        "interests": interests,
        "query_text": np.array([_text(rng, int(rng.integers(1, 6))) for _ in range(n_users)],
                               dtype=object),
    }

    ad_inventory: Columns = {
        "ad_id": np.arange(n_ads, dtype=np.int64),
        "advertiser_id": rng.integers(0, max(2, n_ads // 4), n_ads).astype(np.int64),
        "campaign_id": nullify_int(rng.integers(0, max(2, n_ads // 2), n_ads).astype(np.int64)),
        "bid_price": nullify_float(rng.gamma(2.0, 0.5, n_ads)),
        "title_text": np.array([_text(rng, int(rng.integers(2, 8))) for _ in range(n_ads)],
                               dtype=object),
    }

    basic: Columns = {
        "instance_id": np.arange(n_instances, dtype=np.int64),
        "ctr_7d": rng.beta(1, 20, n_instances).astype(np.float32),
        "user_click_cnt": rng.poisson(5, n_instances).astype(np.float32),
        "ad_show_cnt": rng.poisson(50, n_instances).astype(np.float32),
    }
    return {
        "impressions": impressions,
        "user_profile": user_profile,
        "ad_inventory": ad_inventory,
        "basic_features": basic,
    }


def write_views(store: ColumnStore, views: Dict[str, Columns], *, chunk_rows: int = 4096) -> None:
    """Materialize views into the column store in chunks."""
    for vname, cols in views.items():
        n = None
        for data in cols.values():
            n = data.n_rows if isinstance(data, RaggedColumn) else len(data)
            break
        assert n is not None
        cid = 0
        for start in range(0, n, chunk_rows):
            idx = np.arange(start, min(start + chunk_rows, n))
            chunk: Columns = {}
            for name, data in cols.items():
                chunk[name] = data.take(idx) if isinstance(data, RaggedColumn) else data[idx]
            store.write_chunk(vname, cid, chunk)
            cid += 1


def write_log_shards(
    data_dir: str,
    *,
    n_shards: int = 8,
    rows_per_shard: int = 2048,
    seed: int = 0,
    null_rate: float = 0.05,
) -> List[str]:
    """Materialize the synthetic raw log as on-disk ``.fbshard`` files.

    Each shard is one independently-generated batch of the four views
    (deterministic per ``(seed, shard)``), plus a dataset manifest — the
    scaled-down stand-in for the paper's 15–25 TB sharded log store that
    ``repro_torch.io.StreamingLoader`` ingests.
    """
    from repro_torch.io.convert import write_view_shards  # avoid import cycle

    return write_view_shards(
        data_dir,
        (gen_views(rows_per_shard, seed=seed + i, null_rate=null_rate)
         for i in range(n_shards)),
    )


def gen_criteo_batch(
    batch: int,
    *,
    n_dense: int = 13,
    n_sparse: int = 26,
    vocab_sizes: Optional[List[int]] = None,
    seed: int = 0,
) -> Dict[str, np.ndarray]:
    """Criteo-like direct training batch for the recsys models."""
    rng = np.random.default_rng(seed)
    vocab_sizes = vocab_sizes or [1000] * n_sparse
    sparse = np.stack(
        [rng.integers(0, v, batch).astype(np.int32) for v in vocab_sizes[:n_sparse]],
        axis=1,
    )
    return {
        "dense": rng.exponential(1.0, (batch, n_dense)).astype(np.float32),
        "sparse": sparse,
        "label": (rng.random(batch) < 0.25).astype(np.float32),
    }
