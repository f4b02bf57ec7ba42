# Copy of vrdone_tpu/data/datasets.py, kept so that the port imports nothing of
# vrdone_tpu; tests/test_torch_copies.py pins it to the original.
"""VidVRD / VidOR datasets (host-side, pure numpy).

Reads the same artifacts as the reference stack:
  * annotation JSONs (per video),
  * MEGA GT box-feature pickles ({frame_id: {frame_id, tids,
    visual_features}}, produced offline — reference §L8),
  * BIG proposal pickles ({"traj_proposal": {...}}) for eval,
  * optional CLIP feature pickles (VidOR),
and produces per-SO-pair time-major (T, C) feature sequences plus ragged GT,
which vrdone_tpu/data/batching.py packs into static-shape device batches.

Behavioural parity with reference dataloaders/vidvrd.py + vidor.py:
tracklet interval splitting, relation-instance temporal merging, the
pair-balancing policy, stride subsampling with random phase, window
truncation, and the vIoU>=0.9 tracklet dedup at eval. Caches are pickle
files with the same schema; caches written by the reference (torch tensors
inside) load transparently.
"""

from __future__ import annotations

import json
import os
import pickle
from collections import defaultdict
from copy import deepcopy

import numpy as np

from . import features as F
from . import memmap_cache
from .category import (vidor_category_name_to_id, vidor_pred_name_to_id,
                       vidvrd_category_name_to_id, vidvrd_pred_name_to_id)

TO_REMOVE = 1  # legacy +1 box-area convention shared with the evaluator


def _np(x):
    """Coerce possibly-torch values (reference-written caches) to numpy."""
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def split_tracklet_intervals(frame_ids: np.ndarray) -> np.ndarray:
    """Sorted frame ids -> (K, 2) contiguous [start, end) intervals
    (reference dataloaders/vidvrd.py:204-217)."""
    frame_ids = np.sort(np.asarray(frame_ids))
    diff = frame_ids[1:] - frame_ids[:-1]
    breaks = np.nonzero(diff > 1)[0]
    starts = frame_ids[np.concatenate([[0], breaks + 1]).astype(np.int64)]
    ends = frame_ids[np.concatenate([breaks, [len(frame_ids) - 1]]).astype(np.int64)] + 1
    return np.stack([starts, ends], axis=-1)


def merge_relation_instances(relation_instances: list[dict]) -> list[dict]:
    """Merge temporally-overlapping instances of the same (s, o, predicate)
    triplet into maximal spans (reference dataloaders/vidvrd.py:234-280)."""
    instances = sorted(relation_instances, key=lambda x: x["begin_fid"])
    n = len(instances)
    if n <= 1:
        return deepcopy(instances)
    merged = []
    visited = [False] * n
    for i in range(n):
        if visited[i]:
            continue
        base = deepcopy(instances[i])
        visited[i] = True
        for j in range(i + 1, n):
            cand = instances[j]
            if (base["subject_tid"] == cand["subject_tid"]
                    and base["object_tid"] == cand["object_tid"]
                    and base["predicate"] == cand["predicate"]):
                assert cand["begin_fid"] > base["begin_fid"]
                if cand["begin_fid"] <= base["end_fid"]:
                    assert cand["end_fid"] > base["end_fid"]
                    base["end_fid"] = cand["end_fid"]
                    visited[j] = True
        merged.append(base)
    return sorted(merged, key=lambda x: x["begin_fid"])


def viou_dedup_tracklets(bboxes_list, traj_durations, cat_ids,
                         viou_threshold: float = 0.9) -> np.ndarray:
    """Containment dedup of same-category tracklets (reference
    dataloaders/vidvrd.py:576-646). Dispatches to the native C++ sweep
    (native/tracklet_ops.cpp) when built; numpy loop otherwise."""
    from . import native
    if native.have_native():
        return native.viou_dedup(bboxes_list, traj_durations, cat_ids,
                                 viou_threshold)
    num = len(bboxes_list)
    valid = [True] * num
    for base in range(num):
        if not valid[base]:
            continue
        bd = traj_durations[base]
        for ref in range(base + 1, num):
            if not valid[ref]:
                continue
            if cat_ids[base] != cat_ids[ref]:
                continue
            rd = traj_durations[ref]
            if rd[0] >= bd[1] or rd[1] <= bd[0]:
                continue
            s, e = max(bd[0], rd[0]), min(bd[1], rd[1])
            bb = bboxes_list[base][s - bd[0]:e - bd[0]]
            rb = bboxes_list[ref][s - rd[0]:e - rd[0]]
            area_b = ((bb[:, 2] - bb[:, 0] + TO_REMOVE)
                      * (bb[:, 3] - bb[:, 1] + TO_REMOVE))
            area_r = ((rb[:, 2] - rb[:, 0] + TO_REMOVE)
                      * (rb[:, 3] - rb[:, 1] + TO_REMOVE))
            lt = np.maximum(bb[:, :2], rb[:, :2])
            rbr = np.minimum(bb[:, 2:], rb[:, 2:])
            wh = np.clip(rbr - lt + TO_REMOVE, 0, None)
            inter = (wh[:, 0] * wh[:, 1]).sum()
            viou_br = inter / area_r.sum()
            viou_rb = inter / area_b.sum()
            if (viou_br > viou_threshold and bd[0] <= rd[0]
                    and bd[1] >= rd[1]):
                valid[ref] = False
            elif (viou_rb > viou_threshold and rd[0] <= bd[0]
                  and rd[1] >= bd[1]):
                valid[base] = False
                break
    return np.asarray(valid, bool)


def build_policy(video_num_pairs: list[list], num_pairs: int) -> list[list]:
    """Chunk the corpus-wide pair list into fixed-size loading groups
    (reference dataloaders/vidvrd.py:100-135)."""
    policy = [[]]
    current = 0
    idx = 0
    for video_name, n in video_num_pairs:
        if n + current < num_pairs:
            policy[idx].append([video_name, (0, n)])
            current += n
        else:
            start = 0
            while n + current >= num_pairs:
                take = num_pairs - current
                policy[idx].append([video_name, (start, start + take)])
                n -= take
                start += take
                current = 0
                idx += 1
                policy.append([])
            if n > 0:
                policy[idx].append([video_name, (start, start + n)])
                current += n
    return policy


class PairDataset:
    """Shared logic for VidVRD / VidOR."""

    dataset_name: str = ""
    train_split: str = "train"
    test_split: str = "test"

    def __init__(self, config: dict, scale: int | None = None):
        self.split = config["split"]
        assert self.split in (self.train_split, self.test_split), self.split
        self.is_train = self.split == self.train_split

        self.anno_dir = config["ann_dir"]
        self.cache_tag = config["cache_tag"]
        self.cache_dir = config["cache_dir"]
        self.feat_stride = config["feat_stride"]
        self.max_seq_len = config["max_seq_len"]
        self.with_clip_feature = config.get("with_clip_feature", False)

        self.policy_path = config.get("policy_path") if self.split == \
            self.train_split else None
        self.video_ann_dir = os.path.join(self.anno_dir, self.split)
        self.video_name_list = self._prepare_video_names()
        self.scale = scale
        if scale:
            self.video_name_list = self.video_name_list[:scale]

        if self.is_train:
            self.cut_max_preds = config["cut_max_preds"]
            self.proposal_max_preds = config["proposal_max_preds"]
            self.num_pairs = config["num_pairs"]
            self.gt_boxfeatures_dir = config["gt_boxfeatures_dir"]
            self.clip_training_features_dir = config.get(
                "clip_training_features_dir")
            self.video_num_pairs: list[list] = []
        else:
            self.proposal_min_frames = config["proposal_min_frames"]
            self.random_stride = config["random_stride"]
            self.stride_offset = config["stride_offset"]
            self.info_dir = config["info_dir"]
            self.test_boxfeatures_dir = config.get("test_boxfeatures_dir")
            self.clip_val_proposal_features_dir = config.get(
                "clip_val_proposal_features_dir")
            assert self.proposal_min_frames > self.stride_offset

        cache_name = f"{self.cache_tag}_{self.dataset_name}_{self.split}"
        self.cache_path = os.path.join(self.cache_dir, cache_name)
        os.makedirs(self.cache_path, exist_ok=True)
        # keep caches in RAM except for very large train corpora (VidOR
        # reloads per item in the reference, vidor.py:745-747)
        self.cache_in_memory = config.get("cache_in_memory",
                                          self.dataset_name != "VidOR"
                                          or not self.is_train)
        # memory-mapped packed cache for the out-of-RAM train path: a
        # train item pages in only the rows its pairs slice instead of
        # unpickling the whole video (data/memmap_cache.py)
        self.cache_memmap = config.get("cache_memmap",
                                       self.is_train
                                       and not self.cache_in_memory)
        self._memmap_lru: dict = {}
        self.process_data()

    # -- corpus scan -------------------------------------------------------

    def _prepare_video_names(self) -> list[str]:
        raise NotImplementedError

    def _anno_path(self, video_name: str) -> str:
        raise NotImplementedError

    def process_data(self):
        self.video_features = {}
        # with a persisted policy file, startup does not need to open every
        # per-video cache just to count pairs (reference vidor.py:129-140)
        have_policy_file = bool(self.policy_path
                                and os.path.exists(self.policy_path))
        for video_name in self.video_name_list:
            path = os.path.join(self.cache_path, video_name + ".pkl")
            data = None
            if not os.path.exists(path):
                data = self._prepare_cache(video_name)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    pickle.dump(data, f)
            need = (self.cache_in_memory or not self.is_train
                    or (self.is_train and not have_policy_file)
                    or (self.cache_memmap
                        and not memmap_cache.has_packed(self.cache_path,
                                                        video_name)))
            if data is None and need:
                with open(path, "rb") as f:
                    data = pickle.load(f)
            if self.cache_memmap and not memmap_cache.has_packed(
                    self.cache_path, video_name):
                memmap_cache.write_packed(self.cache_path, video_name, data)
            if self.cache_in_memory or not self.is_train:
                self.video_features[video_name] = data
            if self.is_train and not have_policy_file and len(data) != 0:
                self.video_num_pairs.append(
                    [video_name, len(data["relation_keys"])])
        if self.is_train:
            self._load_or_build_policy()
            self.policy = build_policy(self.video_num_pairs, self.num_pairs)

    def _load_or_build_policy(self):
        """VidOR persists per-video pair counts (reference vidor.py:110-141)."""
        if not self.policy_path:
            return
        if os.path.exists(self.policy_path):
            loaded = []
            names = set(self.video_name_list)
            with open(self.policy_path) as pf:
                for line in pf:
                    name, count = line.strip().split(" ")
                    if name not in names:
                        break
                    loaded.append([name, int(count)])
            self.video_num_pairs = loaded
        else:
            if self.scale:
                raise ValueError(
                    "Remove `scale` and use the whole dataset to generate "
                    "the policy file")
            with open(self.policy_path, "w") as pf:
                for name, count in self.video_num_pairs:
                    pf.write(f"{name} {count}\n")

    def _prepare_cache(self, video_name: str) -> dict:
        if self.is_train:
            return self._prepare_train(video_name)
        return self._prepare_test(video_name)

    # -- train-side cache build -------------------------------------------

    def _prepare_train(self, video_name: str) -> dict:
        with open(self._anno_path(video_name)) as f:
            anno = json.load(f)
        if len(anno["relation_instances"]) == 0:
            return {}
        with open(os.path.join(self.gt_boxfeatures_dir,
                               video_name + ".pkl"), "rb") as f:
            gt_box_features = pickle.load(f)
        gt_clip_features = None
        if self.with_clip_feature:
            with open(os.path.join(self.clip_training_features_dir,
                                   video_name + ".pkl"), "rb") as f:
                gt_clip_features = pickle.load(f)

        traj_frames = defaultdict(list)
        for frame_id, frame_anno in enumerate(anno["trajectories"]):
            for bbox_anno in frame_anno:
                traj_frames[bbox_anno["tid"]].append(frame_id)
        tids = sorted(traj_frames.keys())
        tid_to_index = {t: i for i, t in enumerate(tids)}

        visual_features, entity_bboxes = {}, {}
        clip_features = {} if self.with_clip_feature else None
        entity_classes, traj_intervals = {}, {}
        for tid in tids:
            index = tid_to_index[tid]
            intervals = split_tracklet_intervals(np.asarray(traj_frames[tid]))
            traj_intervals[index] = intervals.tolist()
            iv = intervals.tolist()
            visual_features[index] = F.gather_visual_features(
                gt_box_features, tid, iv)
            entity_bboxes[index] = F.gather_bboxes(
                anno["trajectories"], tid, iv)
            if self.with_clip_feature:
                clip_all = _np(gt_clip_features[tid]).astype(np.float32)
                clips = [clip_all[s:e] for s, e in iv]
                for c in clips:
                    assert not np.any(np.all(c == 0, axis=1))
                clip_features[index] = clips

        for so in anno["subject/objects"]:
            entity_classes[tid_to_index[so["tid"]]] = \
                self.entity_cat_name_to_id[so["category"]]

        relation_merged = defaultdict(list)
        relation_keys = set()
        merged = merge_relation_instances(anno["relation_instances"])
        for rel in merged:
            s_idx = tid_to_index[rel["subject_tid"]]
            o_idx = tid_to_index[rel["object_tid"]]
            bf, ef = rel["begin_fid"], rel["end_fid"]
            s_iv = np.asarray(traj_intervals[s_idx])
            o_iv = np.asarray(traj_intervals[o_idx])
            s_ok = (s_iv[:, 0] <= bf) & (s_iv[:, 1] >= ef)
            o_ok = (o_iv[:, 0] <= bf) & (o_iv[:, 1] >= ef)
            assert s_ok.sum() == 1 and o_ok.sum() == 1
            s_k = int(np.nonzero(s_ok)[0][0])
            o_k = int(np.nonzero(o_ok)[0][0])
            key = (s_idx, o_idx, s_k, o_k)
            relation_merged[key].append({
                "predicate": self.pred_cat_name_to_id[rel["predicate"]],
                "begin_fid": bf,
                "end_fid": ef,
            })
            relation_keys.add(key)

        out = {
            "video_hw": (anno["height"], anno["width"]),
            "relation_merged": dict(relation_merged),
            "relation_keys": [list(k) for k in relation_keys],
            "visual_features": visual_features,
            "entity_bboxes": entity_bboxes,
            "entity_classes": entity_classes,
            "traj_intervals": traj_intervals,
        }
        if self.with_clip_feature:
            out["clip_features"] = clip_features
        return out

    # -- train item --------------------------------------------------------

    def train_pairs(self, input_dict: dict, pair_range=None,
                    rng: np.random.Generator | None = None) -> list[dict]:
        """Assemble per-pair training sequences
        (reference _train_getitem, vidvrd.py:324-457)."""
        if len(input_dict) == 0:
            return []
        rng = rng or np.random.default_rng()
        relation_merged = input_dict["relation_merged"]
        relation_keys = input_dict["relation_keys"]
        if pair_range is not None:
            relation_keys = relation_keys[pair_range[0]:pair_range[1]]
            key_set = {tuple(k) for k in relation_keys}
            relation_merged = {k: v for k, v in relation_merged.items()
                               if tuple(k) in key_set}

        visual_features = input_dict["visual_features"]
        entity_bboxes = input_dict["entity_bboxes"]
        traj_intervals = input_dict["traj_intervals"]
        clip_features = input_dict.get("clip_features")
        h_, w_ = input_dict["video_hw"]

        pairs = []
        for key in relation_merged:
            start_offset = int(rng.integers(0, self.feat_stride))
            s_idx, o_idx, s_k, o_k = key
            rels = relation_merged[key]
            if self.cut_max_preds and self.proposal_max_preds < len(rels):
                continue

            s_iv = traj_intervals[s_idx][s_k]
            o_iv = traj_intervals[o_idx][o_k]
            so_start = max(s_iv[0], o_iv[0])
            so_end = min(s_iv[1], o_iv[1])
            s_d = so_start - s_iv[0]
            o_d = so_start - o_iv[0]
            span = so_end - so_start

            # slice BEFORE coercing so memmap-backed caches only page in
            # the rows this pair touches
            s_feat = _np(visual_features[s_idx][s_k][s_d:s_d + span])
            s_feat = s_feat[start_offset::self.feat_stride]
            o_feat = _np(visual_features[o_idx][o_k][o_d:o_d + span])
            o_feat = o_feat[start_offset::self.feat_stride]
            if s_feat.shape[0] < 2:
                continue

            sbbox = F.clamp_boxes(_np(entity_bboxes[s_idx][s_k]), w_, h_)
            sbbox = sbbox[s_d:s_d + span][start_offset::self.feat_stride]
            obbox = F.clamp_boxes(_np(entity_bboxes[o_idx][o_k]), w_, h_)
            obbox = obbox[o_d:o_d + span][start_offset::self.feat_stride]

            so_bbox_feat = F.so_spatial_features(sbbox, obbox)
            s_bbox_feat = F.entity_spatial_features(sbbox, w=w_, h=h_)
            o_bbox_feat = F.entity_spatial_features(obbox, w=w_, h=h_)

            streams = [s_feat, o_feat]
            if self.with_clip_feature:
                s_clip = _np(clip_features[s_idx][s_k][s_d:s_d + span])
                o_clip = _np(clip_features[o_idx][o_k][o_d:o_d + span])
                streams += [s_clip[start_offset::self.feat_stride],
                            o_clip[start_offset::self.feat_stride]]
            streams += [so_bbox_feat, s_bbox_feat, o_bbox_feat]
            so_feat = np.concatenate(streams, axis=-1)  # (T, C)

            preds, segs = [], []
            for rel in rels:
                l_ = np.ceil((rel["begin_fid"] - so_start - start_offset)
                             / self.feat_stride)
                r_ = np.ceil((rel["end_fid"] - so_start - start_offset)
                             / self.feat_stride)
                if not (l_ < r_):
                    continue
                preds.append(rel["predicate"])
                segs.append([l_, r_])
            if len(preds) == 0:
                continue
            preds = np.asarray(preds, np.int64)
            segs = np.asarray(segs, np.int64)

            trunc = F.truncate_feats(so_feat, preds, segs,
                                     max_seq_len=self.max_seq_len, rng=rng)
            if trunc is None:
                continue
            so_feat, preds, segs = trunc
            masks = F.segments_to_masks(segs, self.max_seq_len)
            pairs.append({"so_feat": so_feat.astype(np.float32),
                          "preds": preds, "segs": segs, "masks": masks})
        return pairs

    def get_train_item(self, idx: int,
                       rng: np.random.Generator | None = None) -> list[dict]:
        """Pairs for one policy group; falls back to a random group when the
        slice yields nothing (reference __getitem__, vidvrd.py:718-748)."""
        rng = rng or np.random.default_rng()
        for _ in range(100):
            pairs = []
            for video_name, pair_range in self.policy[idx]:
                data = self._load_video(video_name)
                pairs += self.train_pairs(data, pair_range, rng)
            if pairs:
                return pairs
            idx = int(rng.integers(0, len(self.policy)))
        raise RuntimeError("could not assemble a non-empty train item")

    def _load_video(self, video_name: str) -> dict:
        if self.cache_in_memory and self.video_features.get(video_name) is not None:
            return self.video_features[video_name]
        if self.cache_memmap and memmap_cache.has_packed(self.cache_path,
                                                         video_name):
            # small LRU of open memmap handles (handles are cheap; the
            # data itself stays on disk until sliced)
            data = self._memmap_lru.pop(video_name, None)
            if data is None:
                data = memmap_cache.load_packed(self.cache_path, video_name)
            self._memmap_lru[video_name] = data
            while len(self._memmap_lru) > 64:
                self._memmap_lru.pop(next(iter(self._memmap_lru)))
            return data
        with open(os.path.join(self.cache_path, video_name + ".pkl"),
                  "rb") as f:
            return pickle.load(f)

    # -- eval side ----------------------------------------------------------

    def _prepare_test(self, video_name: str) -> dict:
        raise NotImplementedError

    def get_test_item(self, idx: int,
                      rng: np.random.Generator | None = None) -> dict | None:
        video_name = self.video_name_list[idx]
        data = self.video_features[video_name]
        out = self._test_pairs(data, rng=rng)
        if len(out) == 0:
            return None
        out["video_name"] = video_name
        return out

    def _test_pairs(self, input_dict: dict, viou_threshold: float = 0.9,
                    rng: np.random.Generator | None = None) -> dict:
        """SO pair assembly for eval: vIoU dedup of near-duplicate tracklets
        then per-pair feature concat (reference _test_getitem,
        vidvrd.py:552-716 / _val_getitem, vidor.py:556-734)."""
        if len(input_dict) == 0:
            return {}
        rng = rng or np.random.default_rng()
        sids = _np(input_dict["sids"]).astype(np.int64)
        oids = _np(input_dict["oids"]).astype(np.int64)
        traj_durations = _np(input_dict["traj_durations"]).astype(np.int64)
        cat_ids = _np(input_dict["cat_ids"]).astype(np.int64)
        bboxes_list = [_np(b).astype(np.float32)
                       for b in input_dict["bboxes_list"]]
        visual_features_list = [_np(v).astype(np.float32)
                                for v in input_dict["visual_features_list"]]
        clip_features_list = None
        if self.with_clip_feature:
            clip_features_list = [_np(v).astype(np.float32)
                                  for v in input_dict["clip_features_list"]]
        w_, h_ = input_dict["video_wh"]

        bboxes_list = [F.clamp_boxes(b, w_, h_) for b in bboxes_list]

        # vIoU >= 0.9 containment dedup over same-category tracklets
        # (native C++ sweep when built — this is the O(N^2 T) host hot spot)
        valid = viou_dedup_tracklets(bboxes_list, traj_durations, cat_ids,
                                     viou_threshold)
        valid_ids = np.nonzero(np.asarray(valid))[0]
        keep = (np.isin(sids, valid_ids) & np.isin(oids, valid_ids))
        sids, oids = sids[keep], oids[keep]
        if len(sids) == 0:
            return {}

        so_features, so_offsets = [], []
        keep2 = np.ones(len(sids), bool)
        for i, (sid, oid) in enumerate(zip(sids, oids)):
            off = (int(rng.integers(0, self.feat_stride))
                   if self.random_stride else self.stride_offset)
            sd, od = traj_durations[sid], traj_durations[oid]
            so_s, so_e = max(sd[0], od[0]), min(sd[1], od[1])
            span = so_e - so_s
            s_d, o_d = so_s - sd[0], so_s - od[0]

            s_feat = visual_features_list[sid][s_d:s_d + span]
            if s_feat.shape[0] < self.proposal_min_frames:
                keep2[i] = False
                continue
            s_feat = s_feat[off::self.feat_stride]
            o_feat = visual_features_list[oid][o_d:o_d + span]
            o_feat = o_feat[off::self.feat_stride]
            if s_feat.shape[0] < 2:
                keep2[i] = False
                continue

            sbbox = bboxes_list[sid][s_d:s_d + span][off::self.feat_stride]
            obbox = bboxes_list[oid][o_d:o_d + span][off::self.feat_stride]
            so_bbox = F.so_spatial_features(sbbox, obbox)
            s_bbox = F.entity_spatial_features(sbbox, w=w_, h=h_)
            o_bbox = F.entity_spatial_features(obbox, w=w_, h=h_)

            streams = [s_feat, o_feat]
            if self.with_clip_feature:
                s_clip = clip_features_list[sid][s_d:s_d + span]
                o_clip = clip_features_list[oid][o_d:o_d + span]
                streams += [s_clip[off::self.feat_stride],
                            o_clip[off::self.feat_stride]]
            streams += [so_bbox, s_bbox, o_bbox]
            so_features.append(
                np.concatenate(streams, axis=-1).astype(np.float32))
            so_offsets.append(off)

        sids, oids = sids[keep2], oids[keep2]
        if len(sids) == 0:
            return {}
        return {
            "sids": sids,
            "oids": oids,
            "cat_ids": cat_ids,
            "cat_scores": _np(input_dict["cat_scores"]).astype(np.float32),
            "traj_durations": traj_durations,
            "bboxes_list": bboxes_list,
            "so_features_list": so_features,
            "so_offset": np.asarray(so_offsets, np.int64),
        }

    def num_train_items(self) -> int:
        return len(self.policy)

    def num_test_items(self) -> int:
        return len(self.video_name_list)


class VidVRDDataset(PairDataset):
    dataset_name = "VidVRD"
    train_split = "train"
    test_split = "test"
    entity_cat_name_to_id = vidvrd_category_name_to_id
    pred_cat_name_to_id = vidvrd_pred_name_to_id

    def _prepare_video_names(self):
        names = os.listdir(self.video_ann_dir)
        return sorted(v.split(".")[0] for v in names)

    def _anno_path(self, video_name):
        return os.path.join(self.video_ann_dir, video_name + ".json")

    def _prepare_test(self, video_name):
        """reference _prepare_test (vidvrd.py:459-550): proposals from the
        BIG repackaged pickle + RoI features from the MEGA test-feature
        pickles."""
        with open(os.path.join(self.info_dir, video_name + ".pkl"),
                  "rb") as f:
            proposal_dict = pickle.load(f)["traj_proposal"]
        if proposal_dict["num_proposals"] < 2:
            return {}
        traj_durations = _np(proposal_dict["traj_durations"]).astype(
            np.int64).copy()
        traj_durations[:, 1] += 1  # left-closed right-open

        cat_ids = _np(proposal_dict["cat_ids"]).astype(np.int64)
        n = len(cat_ids)
        s_ids, o_ids = np.meshgrid(np.arange(n), np.arange(n))
        s_ids, o_ids = s_ids.flatten(), o_ids.flatten()
        ne = s_ids != o_ids
        s_ids, o_ids = s_ids[ne], o_ids[ne]
        start = np.maximum(traj_durations[s_ids, 0], traj_durations[o_ids, 0])
        end = np.minimum(traj_durations[s_ids, 1], traj_durations[o_ids, 1])
        ok = end > start
        if not ok.any():
            return {}
        s_ids, o_ids = s_ids[ok], o_ids[ok]

        with open(os.path.join(self.test_boxfeatures_dir,
                               video_name + ".pkl"), "rb") as f:
            feature_data = pickle.load(f)
        per_tid = defaultdict(list)
        for fid in sorted(feature_data.keys()):
            rec = feature_data[fid]
            assert rec["frame_id"] == fid
            for idx, tid in enumerate(rec["tids"]):
                assert traj_durations[tid][0] <= fid < traj_durations[tid][1]
                per_tid[tid].append(_np(rec["visual_features"])[idx])
        feats = []
        for tid in sorted(per_tid.keys()):
            assert len(per_tid[tid]) == (traj_durations[tid][1]
                                         - traj_durations[tid][0])
            feats.append(np.stack(per_tid[tid], axis=0))

        return {
            "sids": s_ids.astype(np.int64),
            "oids": o_ids.astype(np.int64),
            "cat_ids": cat_ids,
            "cat_scores": _np(proposal_dict["scores"]).astype(np.float32),
            "bboxes_list": [_np(b).astype(np.float32)
                            for b in proposal_dict["bboxes_list"]],
            "traj_durations": traj_durations,
            "visual_features_list": feats,
            "video_wh": proposal_dict["video_wh"],
        }


class VidORDataset(PairDataset):
    dataset_name = "VidOR"
    train_split = "training"
    test_split = "validation"
    entity_cat_name_to_id = vidor_category_name_to_id
    pred_cat_name_to_id = vidor_pred_name_to_id

    def _prepare_video_names(self):
        names = []
        for group in sorted(os.listdir(self.video_ann_dir)):
            for v in sorted(os.listdir(os.path.join(self.video_ann_dir,
                                                    group))):
                names.append(group + "_" + v.split(".")[0])
        return names

    def _anno_path(self, video_name):
        group_id, video_id = video_name.split("_")
        return os.path.join(self.video_ann_dir, group_id, video_id + ".json")

    def _prepare_test(self, video_name):
        """reference _prepare_val (vidor.py:474-554): features ride inside
        the proposal pickle; durations become left-closed by start -= 1."""
        with open(os.path.join(self.info_dir, video_name + ".pkl"),
                  "rb") as f:
            proposal_dict = pickle.load(f)["traj_proposal"]
        if proposal_dict["num_proposals"] < 2:
            return {}
        traj_durations = _np(proposal_dict["traj_durations"]).astype(
            np.int64).copy()
        traj_durations[:, 0] -= 1

        cat_ids = _np(proposal_dict["cat_ids"]).astype(np.int64)
        n = len(cat_ids)
        s_ids, o_ids = np.meshgrid(np.arange(n), np.arange(n))
        s_ids, o_ids = s_ids.flatten(), o_ids.flatten()
        ne = s_ids != o_ids
        s_ids, o_ids = s_ids[ne], o_ids[ne]
        start = np.maximum(traj_durations[s_ids, 0], traj_durations[o_ids, 0])
        end = np.minimum(traj_durations[s_ids, 1], traj_durations[o_ids, 1])
        ok = end > start
        if not ok.any():
            return {}
        s_ids, o_ids = s_ids[ok], o_ids[ok]

        dim_visual = 1024
        feats = [_np(v).astype(np.float32)[:, :dim_visual]
                 for v in proposal_dict["features_list"]]
        out = {
            "sids": s_ids.astype(np.int64),
            "oids": o_ids.astype(np.int64),
            "cat_ids": cat_ids,
            "cat_scores": _np(proposal_dict["scores"]).astype(np.float32),
            "bboxes_list": [_np(b).astype(np.float32)
                            for b in proposal_dict["bboxes_list"]],
            "traj_durations": traj_durations,
            "visual_features_list": feats,
            "video_wh": proposal_dict["video_wh"],
        }
        if self.with_clip_feature:
            with open(os.path.join(self.clip_val_proposal_features_dir,
                                   video_name + ".pkl"), "rb") as f:
                clip = pickle.load(f)
            clips = []
            for idx in range(n):
                c = _np(clip[idx])[traj_durations[idx][0]:
                                   traj_durations[idx][1]]
                assert len(c) == traj_durations[idx][1] - traj_durations[idx][0]
                assert not np.any(np.all(c == 0, axis=1))
                clips.append(c.astype(np.float32))
            out["clip_features_list"] = clips
        return out
