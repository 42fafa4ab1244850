"""The 41-keypoint semantic vocabulary and per-object keypoint configs.

The port's own numpy-only copy of `suo_slam_tpu/kp/config.py` (the port
imports nothing of the JAX package).

Same channel ordering contract as the reference (`lib/labeling/kp_config.py`):
the network predicts one heatmap channel per vocabulary entry, and each object
selects a subset of channels via its row in `kp_configs/<dataset>_kp_config.csv`
(columns: instance, class, has_grip, has_spout, has_brand_name,
has_nutrition_facts, has_bar_code). CSV parsing uses the stdlib (no pandas).
"""

from __future__ import annotations

import csv
import os

import numpy as np

SHAPE_CLASS_KPS = {
    "box_like": [
        "box_corner_front_tl",
        "box_corner_front_tr",
        "box_corner_front_br",
        "box_corner_front_bl",
        "box_corner_back_tl",
        "box_corner_back_tr",
        "box_corner_back_br",
        "box_corner_back_bl",
    ],
    "cylinder_like": [
        "cyl_top_center",
        "cyl_bottom_center",
        "cyl_rim_top_front",
        "cyl_rim_top_back",
        "cyl_rim_top_right",
        "cyl_rim_top_left",
        "cyl_rim_bottom_front",
        "cyl_rim_bottom_back",
        "cyl_rim_bottom_right",
        "cyl_rim_bottom_left",
    ],
    "hand_tool": [
        "tactile_point",
        "rotation_axis",
        "tool_base_front_left",
        "tool_base_front_right",
        "tool_base_back_left",
        "tool_base_back_right",
    ],
}

INSTANCE_SHAPE_KPS = {
    "grip": ["grip_thumb", "grip_palm", "grip_index", "grip_pinky"],
    "spout": ["spout"],
}

INSTANCE_TEXTURE_KPS = {
    "brand_name": ["brand_name_tl", "brand_name_tr", "brand_name_br", "brand_name_bl"],
    "nutrition_facts": [
        "nutrition_facts_tl",
        "nutrition_facts_tr",
        "nutrition_facts_br",
        "nutrition_facts_bl",
    ],
    "bar_code": ["bar_code_tl", "bar_code_tr", "bar_code_br", "bar_code_bl"],
}

_SHAPE_CLASS_KEYS = ["box_like", "cylinder_like", "hand_tool"]
_INSTANCE_SHAPE_KEYS = ["grip", "spout"]
_INSTANCE_TEXTURE_KEYS = ["brand_name", "nutrition_facts", "bar_code"]

KP_LIST: list[str] = []
for _k in _SHAPE_CLASS_KEYS:
    KP_LIST += SHAPE_CLASS_KPS[_k]
for _k in _INSTANCE_SHAPE_KEYS:
    KP_LIST += INSTANCE_SHAPE_KPS[_k]
for _k in _INSTANCE_TEXTURE_KEYS:
    KP_LIST += INSTANCE_TEXTURE_KPS[_k]
assert len(KP_LIST) == len(set(KP_LIST)) == 41

KP_INDEX = {name: i for i, name in enumerate(KP_LIST)}

# Backwards-compatible aliases mirroring the reference API
kp_list = KP_LIST


def num_kp() -> int:
    return len(KP_LIST)


def get_kps(
    class_str: str,
    has_grip: bool,
    has_spout: bool,
    has_brand_name: bool,
    has_nutrition_facts: bool,
    has_bar_code: bool,
) -> dict[str, int]:
    """Map keypoint name -> global channel index for one object config."""
    assert class_str in SHAPE_CLASS_KPS, (
        f"Shape class {class_str} is invalid! Options: {list(SHAPE_CLASS_KPS)}"
    )
    names = list(SHAPE_CLASS_KPS[class_str])
    if has_grip:
        names += INSTANCE_SHAPE_KPS["grip"]
    if has_spout:
        names += INSTANCE_SHAPE_KPS["spout"]
    if has_brand_name:
        names += INSTANCE_TEXTURE_KPS["brand_name"]
    if has_nutrition_facts:
        names += INSTANCE_TEXTURE_KPS["nutrition_facts"]
    if has_bar_code:
        names += INSTANCE_TEXTURE_KPS["bar_code"]
    return {n: KP_INDEX[n] for n in names}


class KpConfig:
    """Per-dataset keypoint configuration loaded from CSV.

    Attributes:
      rows: list of dicts (one per object, BOP obj_id = index + 1).
      kp_map: list of {name: channel} per object.
      kp_names: list of ordered (by channel) names per object.
      channel_mask: [n_obj, 41] bool — which vocabulary channels each object
        uses. This is the padded-array form the device pipeline consumes.
    """

    COLUMNS = [
        "instance",
        "class",
        "has_grip",
        "has_spout",
        "has_brand_name",
        "has_nutrition_facts",
        "has_bar_code",
    ]

    def __init__(self, csv_path: str):
        self.csv_path = csv_path
        self.rows = []
        with open(csv_path, newline="") as f:
            # Header line starts with '# ' in the reference format
            first = f.readline().strip().lstrip("# ")
            header = [c.strip() for c in first.split(",")]
            assert header == self.COLUMNS, f"Bad kp_config header: {header}"
            for rec in csv.reader(f):
                if not rec:
                    continue
                row = dict(zip(self.COLUMNS, [c.strip() for c in rec]))
                for k in self.COLUMNS[2:]:
                    row[k] = bool(int(row[k]))
                self.rows.append(row)

        self.kp_map = []
        self.kp_names = []
        mask = np.zeros((len(self.rows), num_kp()), dtype=bool)
        for i, row in enumerate(self.rows):
            m = get_kps(
                row["class"],
                row["has_grip"],
                row["has_spout"],
                row["has_brand_name"],
                row["has_nutrition_facts"],
                row["has_bar_code"],
            )
            self.kp_map.append(m)
            # Channel-ordered names (reference builds this the same way,
            # `lib/datasets/bop.py:277-281`)
            self.kp_names.append([n for n in KP_LIST if n in m])
            for ch in m.values():
                mask[i, ch] = True
        self.channel_mask = mask

    def __len__(self) -> int:
        return len(self.rows)

    def mask_for(self, obj_id: int) -> np.ndarray:
        """[41] bool channel mask for a 1-based BOP object id."""
        return self.channel_mask[obj_id - 1]


def default_config_path(bop_dset: str, root: str | None = None) -> str:
    root = root or os.path.join(os.path.dirname(__file__), "..", "..", "kp_configs")
    return os.path.normpath(os.path.join(root, f"{bop_dset}_kp_config.csv"))


def load_kp_config(bop_dset: str, root: str | None = None) -> KpConfig:
    return KpConfig(default_config_path(bop_dset, root))


def kp_colors() -> np.ndarray:
    """Deterministic distinct BGR uint8 colors for the 41 keypoints (viz)."""
    n = num_kp()
    hues = (np.arange(n) * 0.61803398875) % 1.0  # golden-ratio spacing
    h = hues * 6.0
    i = h.astype(int) % 6
    f = h - np.floor(h)
    v = np.full(n, 255.0)
    p = np.zeros(n)
    q = v * (1 - f)
    t = v * f
    rgb = np.choose(
        i[:, None],
        [
            np.stack([v, t, p], 1),
            np.stack([q, v, p], 1),
            np.stack([p, v, t], 1),
            np.stack([p, q, v], 1),
            np.stack([t, p, v], 1),
            np.stack([v, p, q], 1),
        ],
    )
    return rgb[:, ::-1].astype(np.int64)  # BGR


def kp_color(kp_name: str) -> np.ndarray:
    return kp_colors()[KP_INDEX[kp_name]]
