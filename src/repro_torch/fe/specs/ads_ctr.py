"""The standard ads CTR pipeline as a declarative spec (paper Fig. 3).

This is the spec form of the original hand-wired ``build_fe_graph()``:
clean the three views, join on user/ad ids, extract JSON context, cross the
id columns, normalize the counters, tokenize the text fields, and merge the
materialized basic features — with identical layer structure, placements,
and output layout (8 sparse fields, 6+3 dense features, 3x16 sequence
block). ``tests/test_spec.py`` asserts schedule equivalence against the
legacy builder.
"""

from __future__ import annotations

from repro_torch.fe.datagen import AD_INVENTORY, BASIC_FEATURES, IMPRESSIONS, USER_PROFILE
from repro_torch.fe.schema import ColType
from repro_torch.fe.spec import (
    Bucketize,
    Cross,
    DenseOutput,
    FeatureSpec,
    Hash,
    Join,
    JsonExtract,
    LogNorm,
    Merge,
    Scale,
    Sequence,
    SequenceOutput,
    Source,
    SparseOutput,
)

SEQ_LEN = 16


def build_spec() -> FeatureSpec:
    return FeatureSpec(
        name="ads_ctr",
        base="impressions",
        sources=(
            Source("impressions", IMPRESSIONS, json=(
                JsonExtract("context_json", (("slot", ColType.INT),
                                             ("device", ColType.INT),
                                             ("geo", ColType.INT))),
            )),
            Source("user_profile", USER_PROFILE),
            Source("ad_inventory", AD_INVENTORY),
            Source("basic_features", BASIC_FEATURES),
        ),
        joins=(
            Join("user_profile", key="user_id", prefix="u_"),
            Join("ad_inventory", key="ad_id", prefix="a_"),
        ),
        merges=(
            Merge("basic_features",
                  columns=("ctr_7d", "user_click_cnt", "ad_show_cnt")),
        ),
        transforms=(
            # engineered crosses (feature combination)
            Cross("x_user_ad", "user_id", "ad_id"),
            Cross("x_user_adv", "user_id", "a_advertiser_id"),
            Cross("x_slot_geo", "slot", "geo"),
            Cross("x_ad_slot", "ad_id", "slot"),
            # raw categorical fields
            Hash("f_user", "user_id"),
            Hash("f_ad", "ad_id"),
            Hash("f_slot", "slot"),
            Hash("f_geo", "geo"),
            # dense features
            LogNorm("d_dwell", "dwell_time"),
            LogNorm("d_bid", "a_bid_price"),
            Scale("d_hour", "hour", denom=24.0),
            Scale("d_age", "u_age_bucket", denom=10.0),
            Bucketize("d_dwell_b", "dwell_time", (0.5, 1, 2, 4, 8, 16)),
            Bucketize("d_bid_b", "a_bid_price", (0.1, 0.3, 1, 3)),
            # text / behavior sequences
            Sequence("interest", "u_interests", max_len=SEQ_LEN),
            Sequence("query", "u_query_text", max_len=SEQ_LEN, ngrams=2),
            Sequence("title", "a_title_text", max_len=SEQ_LEN, ngrams=2),
        ),
        outputs=(
            DenseOutput(("d_dwell", "d_bid", "d_hour", "d_age",
                         "d_dwell_b", "d_bid_b")),
            SparseOutput(("x_user_ad", "x_user_adv", "x_slot_geo",
                          "x_ad_slot", "f_user", "f_ad", "f_slot", "f_geo")),
            SequenceOutput(("interest", "query", "title")),
        ),
        label="label",
    )
