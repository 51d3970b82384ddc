"""Image decode (counterpart of
the JAX package's ``data/uieb.py:29 decode_image``)."""
from __future__ import annotations

from typing import Optional

import numpy as np


def decode_image(path: str, size: Optional[int]) -> np.ndarray:
    """PIL open -> RGB -> bilinear resize to (size, size) -> uint8 HWC.

    PIL is imported here, not at module import: the serving path needs it
    only when it decodes files."""
    from PIL import Image

    with Image.open(path) as im:
        im = im.convert("RGB")
        if size is not None and im.size != (size, size):
            im = im.resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)
