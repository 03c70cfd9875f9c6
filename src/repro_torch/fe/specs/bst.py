"""Behavior-sequence scenario (matches ``configs/bst.py``).

The BST shape: four categorical fields — item (the target ad), user,
category (advertiser), context slot — plus the user's interest list as a
20-step behavior sequence for the transformer block. No dense features and
no basic-feature merge, so the loader projection drops the whole
``basic_features`` table and every text/counter column.
"""

from __future__ import annotations

from repro_torch.fe.datagen import AD_INVENTORY, IMPRESSIONS, USER_PROFILE
from repro_torch.fe.schema import ColType
from repro_torch.fe.spec import (
    FeatureSpec,
    Hash,
    Join,
    JsonExtract,
    Sequence,
    SequenceOutput,
    Source,
    SparseOutput,
)

SEQ_LEN = 20   # bst config seq_len


def build_spec() -> FeatureSpec:
    return FeatureSpec(
        name="bst",
        base="impressions",
        sources=(
            Source("impressions", IMPRESSIONS, json=(
                JsonExtract("context_json", (("slot", ColType.INT),)),
            )),
            Source("user_profile", USER_PROFILE),
            Source("ad_inventory", AD_INVENTORY),
        ),
        joins=(
            Join("user_profile", key="user_id", prefix="u_"),
            Join("ad_inventory", key="ad_id", prefix="a_"),
        ),
        transforms=(
            Hash("f_item", "ad_id", mix=True),
            Hash("f_user", "user_id", mix=True),
            Hash("f_category", "a_advertiser_id"),
            Hash("f_slot", "slot"),
            Sequence("behavior", "u_interests", max_len=SEQ_LEN),
        ),
        outputs=(
            SparseOutput(("f_item", "f_user", "f_category", "f_slot")),
            SequenceOutput(("behavior",)),
        ),
        label="label",
    )
