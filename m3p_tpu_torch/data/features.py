"""Region-feature storage (a copy of `m3p_tpu/data/features.py`): the h5
reader `RegionFeatureStore`, `write_feature_shard`, and the geometry and
feature normalization.

Reference keys: ``features`` (N, R, 2048), ``bbox``/``boxes`` (N, R, 4),
``num_boxes`` (N,), ``wh`` (N, 2), ``image_id`` (N,), and either
``objects`` (N, R) class ids or ``distribution`` (N, R, 1600) (argmaxed to
classes).

  * 5-d geometry = [x1/w, y1/h, x2/w, y2/h, area/(wh)], then L2-normalized
  * features L2-normalized along the last dim for model input; the raw
    features are kept for the MRFR regression target
  * each thread opens its own h5 handles, lazily, so the loader's read
    threads share none

``h5py`` is imported where a shard is opened or written, never when this
module is imported: a machine without it can use every other part of the
port, and drive the datasets through an in-memory store with the same
methods (`get`, `get_into`, `index_of`, `image_ids`, `feat_dim`).
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np


def norm_boxes(boxes: np.ndarray, h: float, w: float) -> np.ndarray:
    """(R, 4) x1y1x2y2 -> L2-normalized (R, 5) [x1/w, y1/h, x2/w, y2/h, area]."""
    x1, y1, x2, y2 = np.hsplit(boxes.astype(np.float32), 4)
    out = np.hstack((x1 / w, y1 / h, x2 / w, y2 / h,
                     (x2 - x1) * (y2 - y1) / (w * h)))
    norm = np.linalg.norm(out, 2, axis=1, keepdims=True)
    return out / np.maximum(norm, 1e-12)


def l2_normalize(feats: np.ndarray) -> np.ndarray:
    norm = np.linalg.norm(feats, 2, axis=-1, keepdims=True)
    return feats / np.maximum(norm, 1e-12)


class RegionFeatureStore:
    """Lazy h5-backed region features for one shard file."""

    def __init__(self, path: str, max_region_num: int = 100):
        self.path = path
        self.max_region_num = max_region_num
        self._local = threading.local()

    # a store that crosses a process boundary ships its path only: open h5
    # handles must not be shared between processes
    def __getstate__(self):
        return {"path": self.path, "max_region_num": self.max_region_num}

    def __setstate__(self, state):
        self.path = state["path"]
        self.max_region_num = state["max_region_num"]
        self._local = threading.local()

    def _handles(self):
        if not hasattr(self._local, "f"):
            import h5py

            f = h5py.File(self.path, "r")
            self._local.f = f
            self._local.features = f["features"]
            self._local.boxes = f["bbox"] if "bbox" in f else f["boxes"]
            self._local.num_boxes = f["num_boxes"]
            self._local.wh = f["wh"]
            ids = f["image_id"][...]
            if ids.dtype.kind in ("S", "O"):
                ids = np.array([x.decode() if isinstance(x, bytes) else str(x)
                                for x in ids])
            self._local.image_ids = ids
            self._local.objects = f["objects"] if "objects" in f else (
                f["object"] if "object" in f else None)
            self._local.distribution = (f["distribution"]
                                        if "distribution" in f else None)
            self._local.id_to_index = {str(i): n for n, i
                                       in enumerate(ids)}
        return self._local

    def __len__(self) -> int:
        return self._handles().features.shape[0]

    @property
    def feat_dim(self) -> int:
        return int(self._handles().features.shape[-1])

    @property
    def image_ids(self) -> np.ndarray:
        return self._handles().image_ids

    def index_of(self, image_id: str) -> int:
        return self._handles().id_to_index[str(image_id)]

    def get(self, index: int, normalize: bool = True
            ) -> Dict[str, np.ndarray]:
        """Returns feats (R, 2048), raw_feats, locs (R, 5), mask (R,),
        objects (R,) padded to max_region_num."""
        h = self._handles()
        r = self.max_region_num
        raw = np.asarray(h.features[index][:r], np.float32)
        boxes = np.asarray(h.boxes[index][:r], np.float32)
        height, width = np.asarray(h.wh[index], np.float32)
        n = min(int(h.num_boxes[index]), r)
        if h.objects is not None:
            objects = np.asarray(h.objects[index][:r], np.int32)
        elif h.distribution is not None:
            objects = np.asarray(
                h.distribution[index][:r], np.float32).argmax(-1).astype(np.int32)
        else:
            objects = np.full((raw.shape[0],), -1, np.int32)

        locs = norm_boxes(boxes, height, width)
        feats = l2_normalize(raw) if normalize else raw

        def pad(a, fill=0):
            if a.shape[0] < r:
                pad_width = [(0, r - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
                a = np.pad(a, pad_width, constant_values=fill)
            return a

        mask = np.zeros((r,), np.int32)
        mask[:n] = 1
        return {
            "feats": pad(feats),
            "raw_feats": pad(raw),
            "locs": pad(locs),
            "mask": mask,
            "objects": pad(objects, fill=-1),
            "num_boxes": np.int32(n),
        }

    def get_into(self, index: int, raw_out: np.ndarray, locs_out: np.ndarray,
                 objects_out: np.ndarray) -> int:
        """Fill caller-owned (R, D) / (R, 5) / (R,) buffers with the RAW
        features, the 5-d geometry and the object classes of one image;
        returns num_boxes.  No L2 normalization (the compact batches are
        normalized on the device, `train.steps.expand_compact_batch`) and
        no intermediate arrays."""
        h = self._handles()
        r = self.max_region_num
        n = min(int(h.num_boxes[index]), r)
        raw = np.asarray(h.features[index][:r], np.float32)
        rows = raw.shape[0]
        raw_out[:rows] = raw
        raw_out[rows:] = 0.0
        boxes = np.asarray(h.boxes[index][:r], np.float32)
        height, width = np.asarray(h.wh[index], np.float32)
        locs_out[:rows] = norm_boxes(boxes, height, width)
        locs_out[rows:] = 0.0
        if h.objects is not None:
            objects_out[:rows] = np.asarray(h.objects[index][:r], np.int32)
        elif h.distribution is not None:
            objects_out[:rows] = np.asarray(
                h.distribution[index][:r], np.float32).argmax(-1)
        else:
            objects_out[:rows] = -1
        objects_out[rows:] = -1
        return n


def write_feature_shard(path: str, features, boxes, num_boxes, wh, image_ids,
                        objects=None, distribution=None) -> None:
    """Write a reference-layout h5 shard (tests and preprocessing)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("features", data=features)
        f.create_dataset("bbox", data=boxes)
        f.create_dataset("num_boxes", data=num_boxes)
        f.create_dataset("wh", data=wh)
        ids = np.array([str(i).encode() for i in image_ids])
        f.create_dataset("image_id", data=ids)
        if objects is not None:
            f.create_dataset("objects", data=objects)
        if distribution is not None:
            f.create_dataset("distribution", data=distribution)
