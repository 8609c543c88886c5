"""labelme annotations: a reader and a shape rasterizer, with no labelme
package.

The port of ``dino_tpu``'s ``data/labelme_io.py``: ``LabelFile`` reads a
``.json`` annotation (embedded image data or a path beside it) and
``shapes_to_label`` rasterizes its shapes (polygon, rectangle, circle,
line, linestrip, point) to an integer label map with Pillow's ``ImageDraw``,
so the masks have ``dino_tpu``'s bytes.  Pillow is imported inside the
functions that use it: the card path never imports it.
"""
from __future__ import annotations

import base64
import io
import json
import math
import os.path as osp
from typing import Any, Dict, List, Tuple

import numpy as np


class LabelFile:
    """A parsed labelme ``.json`` annotation."""

    def __init__(self, filename: str):
        with open(filename) as f:
            data = json.load(f)
        self.shapes: List[Dict[str, Any]] = data.get("shapes", [])
        if data.get("imageData"):
            self.image_data = base64.b64decode(data["imageData"])
        else:
            img_path = osp.join(osp.dirname(filename), data["imagePath"])
            with open(img_path, "rb") as f:
                self.image_data = f.read()
        self.image_height = data.get("imageHeight")
        self.image_width = data.get("imageWidth")

    @property
    def imageData(self):  # labelme's attribute name
        return self.image_data


def img_data_to_arr(image_data: bytes) -> np.ndarray:
    from PIL import Image
    return np.array(Image.open(io.BytesIO(image_data)))


def shape_to_mask(img_shape: Tuple[int, ...], points, shape_type="polygon",
                  line_width: int = 10, point_size: int = 5) -> np.ndarray:
    """Rasterize one labelme shape to a boolean mask (labelme's
    semantics)."""
    from PIL import Image, ImageDraw
    mask = Image.fromarray(np.zeros(img_shape[:2], dtype=np.uint8))
    draw = ImageDraw.Draw(mask)
    xy = [tuple(p) for p in points]
    if shape_type == "circle":
        assert len(xy) == 2
        (cx, cy), (px, py) = xy
        r = math.hypot(cx - px, cy - py)
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], outline=1, fill=1)
    elif shape_type == "rectangle":
        assert len(xy) == 2
        draw.rectangle(xy, outline=1, fill=1)
    elif shape_type == "line":
        assert len(xy) == 2
        draw.line(xy=xy, fill=1, width=line_width)
    elif shape_type == "linestrip":
        draw.line(xy=xy, fill=1, width=line_width)
    elif shape_type == "point":
        assert len(xy) == 1
        (cx, cy) = xy[0]
        r = point_size
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], outline=1, fill=1)
    else:  # polygon
        assert len(xy) > 2, "Polygon must have points more than 2"
        draw.polygon(xy=xy, outline=1, fill=1)
    return np.array(mask, dtype=bool)


def shapes_to_label(img_shape: Tuple[int, ...], shapes,
                    label_name_to_value: Dict[str, int]) -> np.ndarray:
    """Rasterize shapes in order onto an int label map (later shapes
    win)."""
    label = np.zeros(img_shape[:2], dtype=np.int32)
    for shape in shapes:
        mask = shape_to_mask(img_shape, shape["points"],
                             shape.get("shape_type", "polygon"))
        label[mask] = label_name_to_value[shape["label"]]
    return label
