"""The standard ads FE pipeline as an operator graph (paper Fig. 3).

DEPRECATED surface: the pipeline is *defined* declaratively in
``repro_torch.fe.specs.ads_ctr`` and lowered by ``repro_torch.fe.compiler``;
:func:`build_fe_graph` is a thin compat wrapper that compiles that spec.
Prefer the one-call front door::

    from repro_torch.fe import featureplan
    from repro_torch.fe.specs import get_spec
    plan = featureplan.compile(get_spec("ads_ctr"))

:func:`build_fe_graph_legacy` builds the original hand-wired graph, kept so a
test can assert that the compiled spec is schedule-equivalent (same layers,
placements, outputs) and bit for bit equal in its outputs.

Placements match the paper either way:

* clean / json-extract / tokenize / join — HOST (string + dictionary work),
* hash-cross / bucketize / lognorm / sparse-id mapping — DEVICE, fused into
  per-layer meta-kernels by the scheduler.

The graph's external inputs are the per-batch raw view slices, so the same
graph runs under both the pipelined and the staged executor. Its device ops
are plain PyTorch ops on the device's tensors; integer columns are narrowed
to their low 32 bits read as signed int32 (``F.narrow_int32``), as the JAX
graph's jit does with x64 off.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.core.opgraph import Device, OpCost, Operator, OpGraph
from repro_torch.fe import ops as F
from repro_torch.fe.colstore import Columns
from repro_torch.fe.datagen import AD_INVENTORY, IMPRESSIONS, USER_PROFILE
from repro_torch.fe.join import hash_join, merge_on_instance
from repro_torch.fe.schema import ColType
from repro_torch.fe.views import extract_json_fields, fill_nulls

# Feature space layout: per-field hash sizes (scaled-down production layout).
FIELD_SIZE = 1 << 20
N_CROSS = 4          # engineered cross features
SEQ_LEN = 16         # padded interest-sequence length
DENSE_DIM = 6        # dense features after extraction


def build_fe_graph(*, field_size: int = FIELD_SIZE) -> OpGraph:
    """Compat wrapper: compile the declarative ``ads_ctr`` spec."""
    from repro_torch.fe import compiler
    from repro_torch.fe.specs import ads_ctr

    return compiler.lower(ads_ctr.build_spec(), field_size=field_size)


def _scale(x: torch.Tensor, denom: float) -> torch.Tensor:
    # JAX's x / denom under jit is x * (1 / denom), the reciprocal rounded
    # to float32 (ROADMAP C5)
    return F.narrow_int32(x).to(torch.float32) * float(np.float32(1.0) / np.float32(denom))


def build_fe_graph_legacy(*, field_size: int = FIELD_SIZE) -> OpGraph:
    """The original hand-wired graph (reference for equivalence tests)."""
    g = OpGraph()
    g.mark_external("impressions", "user_profile", "ad_inventory", "basic_features")

    # ---------------------------------------------------------- clean (HOST)
    def clean_impressions(impressions: Columns) -> Dict[str, Columns]:
        ctx_fields = {"slot": ColType.INT, "device": ColType.INT,
                      "geo": ColType.INT}
        cols = extract_json_fields(impressions, "context_json", ctx_fields)
        return {"imp_clean": fill_nulls(cols, IMPRESSIONS,
                                        extracted=ctx_fields)}

    g.add(Operator("clean_impressions", clean_impressions,
                   ("impressions",), ("imp_clean",), device=Device.HOST))

    def clean_user(user_profile: Columns) -> Dict[str, Columns]:
        return {"user_clean": fill_nulls(user_profile, USER_PROFILE)}

    g.add(Operator("clean_user", clean_user, ("user_profile",), ("user_clean",),
                   device=Device.HOST))

    def clean_ads(ad_inventory: Columns) -> Dict[str, Columns]:
        return {"ads_clean": fill_nulls(ad_inventory, AD_INVENTORY)}

    g.add(Operator("clean_ads", clean_ads, ("ad_inventory",), ("ads_clean",),
                   device=Device.HOST))

    # ----------------------------------------------------------- join (HOST)
    # "large table joins (which corresponds to a large dictionary lookup)"
    def join_all(imp_clean: Columns, user_clean: Columns, ads_clean: Columns) -> Dict[str, Columns]:
        t = hash_join(imp_clean, user_clean, key="user_id", right_prefix="u_")
        t = hash_join(t, ads_clean, key="ad_id", right_prefix="a_")
        return {"joined": t}

    g.add(Operator("join_views", join_all,
                   ("imp_clean", "user_clean", "ads_clean"), ("joined",),
                   device=Device.HOST,
                   cost=OpCost(bytes_touched=8 * 1024**3)))

    # ------------------------------------------- host-side string extraction
    def extract_text(joined: Columns) -> Dict[str, object]:
        q = F.tokenize_hash(joined["u_query_text"], field_size=FIELD_SIZE, ngrams=2)
        t = F.tokenize_hash(joined["a_title_text"], field_size=FIELD_SIZE, ngrams=2)
        q_ids, q_mask = F.ragged_to_padded(q, max_len=SEQ_LEN)
        t_ids, t_mask = F.ragged_to_padded(t, max_len=SEQ_LEN)
        iv, im = F.ragged_to_padded(joined["u_interests"], max_len=SEQ_LEN)
        return {
            "query_ids": q_ids, "query_mask": q_mask,
            "title_ids": t_ids, "title_mask": t_mask,
            "interest_ids": iv, "interest_mask": im,
        }

    g.add(Operator("extract_text", extract_text, ("joined",),
                   ("query_ids", "query_mask", "title_ids", "title_mask",
                    "interest_ids", "interest_mask"),
                   device=Device.HOST))

    # --------------------------------- numeric columns to device (H2D stage)
    def to_device_cols(joined: Columns) -> Dict[str, np.ndarray]:
        return {
            "user_id_col": np.asarray(joined["user_id"], np.int64),
            "ad_id_col": np.asarray(joined["ad_id"], np.int64),
            "advertiser_col": np.asarray(joined["a_advertiser_id"], np.int64),
            "slot_col": np.asarray(joined["slot"], np.int64),
            "geo_col": np.asarray(joined["geo"], np.int64),
            "age_col": np.asarray(joined["u_age_bucket"], np.int64),
            "hour_col": np.asarray(joined["hour"], np.int64),
            "dwell_col": np.asarray(joined["dwell_time"], np.float32),
            "bid_col": np.asarray(joined["a_bid_price"], np.float32),
            "label_col": np.asarray(joined["label"], np.float32),
            "instance_col": np.asarray(joined["instance_id"], np.int64),
        }

    g.add(Operator("to_device", to_device_cols, ("joined",),
                   ("user_id_col", "ad_id_col", "advertiser_col", "slot_col",
                    "geo_col", "age_col", "hour_col", "dwell_col", "bid_col",
                    "label_col", "instance_col"),
                   device=Device.HOST))

    # ---------------------------------------------- extract (DEVICE, torch)
    def cross_features(user_id_col, ad_id_col, advertiser_col, slot_col, geo_col):
        return {
            "x_user_ad": F.cross_feature(user_id_col, ad_id_col, field_size=field_size),
            "x_user_adv": F.cross_feature(user_id_col, advertiser_col, field_size=field_size),
            "x_slot_geo": F.cross_feature(slot_col, geo_col, field_size=field_size),
            "x_ad_slot": F.cross_feature(ad_id_col, slot_col, field_size=field_size),
        }

    g.add(Operator("cross_features", cross_features,
                   ("user_id_col", "ad_id_col", "advertiser_col", "slot_col", "geo_col"),
                   ("x_user_ad", "x_user_adv", "x_slot_geo", "x_ad_slot"),
                   device=Device.DEVICE))

    def dense_features(dwell_col, bid_col, hour_col, age_col):
        return {
            "dense_feats": torch.stack(
                [
                    F.log_norm(dwell_col),
                    F.log_norm(bid_col),
                    _scale(hour_col, 24.0),
                    _scale(age_col, 10.0),
                    F.bucketize(dwell_col, (0.5, 1, 2, 4, 8, 16)).to(torch.float32),
                    F.bucketize(bid_col, (0.1, 0.3, 1, 3)).to(torch.float32),
                ],
                dim=1,
            )
        }

    g.add(Operator("dense_features", dense_features,
                   ("dwell_col", "bid_col", "hour_col", "age_col"),
                   ("dense_feats",), device=Device.DEVICE))

    def sparse_ids(x_user_ad, x_user_adv, x_slot_geo, x_ad_slot,
                   user_id_col, ad_id_col, slot_col, geo_col):
        fields = [x_user_ad, x_user_adv, x_slot_geo, x_ad_slot,
                  torch.remainder(F.narrow_int32(user_id_col), field_size),
                  torch.remainder(F.narrow_int32(ad_id_col), field_size),
                  torch.remainder(F.narrow_int32(slot_col), field_size),
                  torch.remainder(F.narrow_int32(geo_col), field_size)]
        # global sparse id space: field i occupies [i*field_size, (i+1)*field_size)
        # (8 fields x 2^20 slots < 2^31, so int32 ids are exact)
        ids = torch.stack(
            [f.to(torch.int32) + i * field_size for i, f in enumerate(fields)], dim=1)
        return {"sparse_ids": ids}

    g.add(Operator("sparse_ids", sparse_ids,
                   ("x_user_ad", "x_user_adv", "x_slot_geo", "x_ad_slot",
                    "user_id_col", "ad_id_col", "slot_col", "geo_col"),
                   ("sparse_ids",), device=Device.DEVICE))

    # ------------------------------------------------------ merge (HOST+DEV)
    def merge_basic(basic_features: Columns, instance_col) -> Dict[str, np.ndarray]:
        # join basic features on instance id (paper: "join operation on the
        # instance id"); basic table is already instance-aligned per chunk but
        # we do the real dictionary join for faithfulness.
        probe: Columns = {"instance_id": np.asarray(instance_col)}
        merged = merge_on_instance(probe, basic_features)
        return {
            "basic_dense": np.stack(
                [merged["basic_ctr_7d"], merged["basic_user_click_cnt"],
                 merged["basic_ad_show_cnt"]], axis=1
            ).astype(np.float32)
        }

    g.add(Operator("merge_basic", merge_basic, ("basic_features", "instance_col"),
                   ("basic_dense",), device=Device.HOST,
                   cost=OpCost(bytes_touched=4 * 1024**3)))

    def final_batch(dense_feats, basic_dense, sparse_ids, interest_ids, interest_mask,
                    query_ids, query_mask, title_ids, title_mask, label_col):
        return {
            "batch_dense": torch.cat([dense_feats, basic_dense], dim=1),
            "batch_sparse": sparse_ids,
            "batch_seq_ids": torch.cat(
                [F.narrow_int32(interest_ids), F.narrow_int32(query_ids),
                 F.narrow_int32(title_ids)], dim=1),
            "batch_seq_mask": torch.cat([interest_mask, query_mask, title_mask], dim=1),
            "batch_label": label_col,
        }

    g.add(Operator("final_batch", final_batch,
                   ("dense_feats", "basic_dense", "sparse_ids",
                    "interest_ids", "interest_mask", "query_ids", "query_mask",
                    "title_ids", "title_mask", "label_col"),
                   ("batch_dense", "batch_sparse", "batch_seq_ids",
                    "batch_seq_mask", "batch_label"),
                   device=Device.DEVICE))
    return g


N_SPARSE_FIELDS = 8
N_DENSE_FEATS = DENSE_DIM + 3  # extracted + basic
