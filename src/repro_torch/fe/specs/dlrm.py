"""DLRM-style dense + multi-hot scenario (matches ``configs/dlrm_mlperf.py``).

Same raw ads views, different shape: 13 dense features (10 engineered +
3 merged basic features) and 26 sparse fields (10 raw categorical hashes +
16 crosses) — the MLPerf DLRM layout — plus the interest list as a
multi-hot bag. No free-text columns are touched, so the loader projection
skips decoding ``query_text``/``title_text`` entirely.
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

BAG_LEN = 16

_CROSSES = (
    ("x_user_ad", "user_id", "ad_id"),
    ("x_user_adv", "user_id", "a_advertiser_id"),
    ("x_user_camp", "user_id", "a_campaign_id"),
    ("x_user_slot", "user_id", "slot"),
    ("x_user_geo", "user_id", "geo"),
    ("x_user_dev", "user_id", "device"),
    ("x_user_hour", "user_id", "hour"),
    ("x_ad_slot", "ad_id", "slot"),
    ("x_ad_geo", "ad_id", "geo"),
    ("x_ad_dev", "ad_id", "device"),
    ("x_ad_hour", "ad_id", "hour"),
    ("x_adv_slot", "a_advertiser_id", "slot"),
    ("x_adv_geo", "a_advertiser_id", "geo"),
    ("x_camp_slot", "a_campaign_id", "slot"),
    ("x_slot_geo", "slot", "geo"),
    ("x_geo_dev", "geo", "device"),
)

_HASHES = (
    ("f_user", "user_id", True),     # mixed: raw ids correlate with fields
    ("f_ad", "ad_id", True),
    ("f_adv", "a_advertiser_id", False),
    ("f_camp", "a_campaign_id", False),
    ("f_slot", "slot", False),
    ("f_geo", "geo", False),
    ("f_dev", "device", False),
    ("f_hour", "hour", False),
    ("f_age", "u_age_bucket", False),
    ("f_gender", "u_gender", False),
)


def build_spec() -> FeatureSpec:
    return FeatureSpec(
        name="dlrm",
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
            *(Cross(name, a, b) for name, a, b in _CROSSES),
            *(Hash(name, col, mix=mix) for name, col, mix in _HASHES),
            LogNorm("d_dwell", "dwell_time"),
            LogNorm("d_bid", "a_bid_price"),
            Scale("d_hour", "hour", denom=24.0),
            Scale("d_age", "u_age_bucket", denom=10.0),
            Scale("d_gender", "u_gender", denom=3.0),
            Scale("d_slot", "slot", denom=16.0),
            Scale("d_dev", "device", denom=4.0),
            Bucketize("d_dwell_b", "dwell_time", (0.5, 1, 2, 4, 8, 16)),
            Bucketize("d_bid_b", "a_bid_price", (0.1, 0.3, 1, 3)),
            Bucketize("d_hour_b", "hour", (6, 12, 18)),
            Sequence("interest_bag", "u_interests", max_len=BAG_LEN),
        ),
        outputs=(
            # 10 engineered + 3 merged basic = 13 dense (dlrm-mlperf n_dense)
            DenseOutput(("d_dwell", "d_bid", "d_hour", "d_age", "d_gender",
                         "d_slot", "d_dev", "d_dwell_b", "d_bid_b",
                         "d_hour_b")),
            # 26 sparse fields (dlrm-mlperf n_sparse)
            SparseOutput(tuple(n for n, _, _ in _CROSSES)
                         + tuple(n for n, _, _ in _HASHES)),
            SequenceOutput(("interest_bag",)),   # the multi-hot bag
        ),
        label="label",
    )
