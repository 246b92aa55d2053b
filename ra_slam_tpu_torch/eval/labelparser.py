"""NYU40 label maps for ScanNet semantic evaluation (counterpart of
`ra_slam_tpu/eval/labelparser.py`).

Maps nyu40 class ids to class names and to the hand-curated binary
high-touch/low-touch split of the disinfection task. The canonical
nyu40 id->class table is built in; a local
`scannetv2-labels.combined.tsv` can override it.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional

# Canonical NYU40 id -> class name (the 40-class nyu40class column of
# scannetv2-labels.combined.tsv).
NYU40_ID_TO_CLASS: Dict[int, str] = {
    1: "wall",
    2: "floor",
    3: "cabinet",
    4: "bed",
    5: "chair",
    6: "sofa",
    7: "table",
    8: "door",
    9: "window",
    10: "bookshelf",
    11: "picture",
    12: "counter",
    13: "blinds",
    14: "desk",
    15: "shelves",
    16: "curtain",
    17: "dresser",
    18: "pillow",
    19: "mirror",
    20: "floor mat",
    21: "clothes",
    22: "ceiling",
    23: "books",
    24: "refridgerator",
    25: "television",
    26: "paper",
    27: "towel",
    28: "shower curtain",
    29: "box",
    30: "whiteboard",
    31: "person",
    32: "night stand",
    33: "toilet",
    34: "sink",
    35: "lamp",
    36: "bathtub",
    37: "bag",
    38: "otherstructure",
    39: "otherfurniture",
    40: "otherprop",
}

# Hand-curated class -> high-touch(1)/low-touch(0) map (parity with the
# reference's NYU40_HT_DICT; the task definition of "high touch").
NYU40_HT_DICT: Dict[str, int] = {
    "wall": 0,
    "bookshelf": 1,
    "picture": 0,
    "counter": 1,
    "blinds": 0,
    "desk": 1,
    "shelves": 1,
    "curtain": 1,
    "dresser": 1,
    "pillow": 1,
    "mirror": 0,
    "floor": 0,
    "floor mat": 1,
    "clothes": 0,
    "ceiling": 0,
    "books": 1,
    "refridgerator": 1,
    "television": 0,
    "paper": 0,
    "towel": 1,
    "shower curtain": 1,
    "box": 1,
    "cabinet": 1,
    "whiteboard": 0,
    "person": 0,
    "night stand": 1,
    "toilet": 1,
    "sink": 1,
    "lamp": 1,
    "bathtub": 1,
    "bag": 0,
    "otherstructure": 1,
    "otherfurniture": 1,
    "bed": 1,
    "otherprop": 1,
    "chair": 1,
    "sofa": 1,
    "table": 1,
    "door": 1,
    "window": 0,
}


class LabelParser:
    """nyu40 id -> class / high-touch maps (reference LabelParser API)."""

    def __init__(self, labels_tsv: Optional[str] = None):
        if labels_tsv is not None:
            self.nyu40_dict: Dict[int, str] = {}
            with open(labels_tsv, newline="") as f:
                for row in csv.DictReader(f, delimiter="\t"):
                    nid = int(row["nyu40id"])
                    cls = row["nyu40class"]
                    if self.nyu40_dict.setdefault(nid, cls) != cls:
                        raise ValueError(
                            f"{labels_tsv}: nyu40 id {nid} is both "
                            f"{self.nyu40_dict[nid]!r} and {cls!r}"
                        )
        else:
            self.nyu40_dict = dict(NYU40_ID_TO_CLASS)

    def get_nyuid_to_nyuclass_map(self) -> Dict[int, str]:
        return self.nyu40_dict

    def get_nyuid_to_ht_map(self) -> Dict[int, int]:
        return {k: NYU40_HT_DICT[v] for k, v in self.nyu40_dict.items()}
