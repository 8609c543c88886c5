"""PIL-space augmentations of the DINO multi-crop pretraining recipe: the
port of ``dino_tpu``'s ``data/pil_augs.py`` (the reference's GaussianBlur
and Solarization, each a PIL call whose parameters are the contract).
Pillow is imported when a transform runs."""
from __future__ import annotations

import random


class GaussianBlur:
    """Blur with a radius drawn from [radius_min, radius_max], with
    probability ``p``."""

    def __init__(self, p: float = 0.5, radius_min: float = 0.1,
                 radius_max: float = 2.0):
        self.prob = p
        self.radius_min = radius_min
        self.radius_max = radius_max

    def __call__(self, img):
        from PIL import ImageFilter
        if random.random() > self.prob:
            return img
        return img.filter(ImageFilter.GaussianBlur(
            radius=random.uniform(self.radius_min, self.radius_max)))


class Solarization:
    """Invert the pixels at or above 128, with probability ``p``."""

    def __init__(self, p: float):
        self.p = p

    def __call__(self, img):
        from PIL import ImageOps
        if random.random() < self.p:
            return ImageOps.solarize(img)
        return img
