"""labels.txt parsing: line 0 must be ``__ignore__`` (class id -1,
excluded), line 1 ``_background_`` (class id 0)."""
from __future__ import annotations

from typing import Dict, Tuple


def parse_class_names(path: str) -> Tuple[Tuple[str, ...], Dict[str, int]]:
    """(class names from id 0 on, name -> id including ``__ignore__``)."""
    class_names = []
    class_name_to_id: Dict[str, int] = {}
    with open(path) as f:
        for i, line in enumerate(f.readlines()):
            class_id = i - 1  # starts with -1
            class_name = line.strip()
            class_name_to_id[class_name] = class_id
            if class_id == -1:
                if class_name != "__ignore__":
                    raise ValueError(f"{path}: line 1 must be __ignore__, "
                                     f"got {class_name!r}")
                continue
            if class_id == 0 and class_name != "_background_":
                raise ValueError(f"{path}: line 2 must be _background_, got "
                                 f"{class_name!r}")
            class_names.append(class_name)
    return tuple(class_names), class_name_to_id
