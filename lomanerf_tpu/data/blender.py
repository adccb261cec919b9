"""Blender-synthetic dataset loader (NeRFDataset equivalent).

Same on-disk format and semantics as the reference loader
(/root/reference/dataloader.py:10-56): ``<root>/transforms_<phase>.json``
lists frames with ``file_path`` (png, extension added) and a 4x4
``transform_matrix``; images are resized to ``img_size`` square, RGB,
scaled to [0,1]; the normalized focal length is
``0.5 / tan(0.5 * camera_angle_x)``.

No torch dependency (the reference subclasses torch's Dataset purely for
``__getitem__``; a plain sequence protocol is equivalent).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np


class NeRFDataset:
    """Sequence of {image, pose, focal_length} samples."""

    def __init__(self, root_dir: str, img_size: int = 16, phase: str = "train"):
        self.root_dir = root_dir
        self.img_size = img_size
        self.phase = phase
        self.data: List[Tuple[str, np.ndarray]] = []
        path = os.path.join(root_dir, f"transforms_{phase}.json")
        with open(path) as f:
            transforms = json.load(f)
        self.camera_angle_x = float(transforms["camera_angle_x"])
        for frame in transforms["frames"]:
            img_path = os.path.join(root_dir, frame["file_path"] + ".png")
            self.data.append(
                (img_path, np.array(frame["transform_matrix"], dtype=np.float32))
            )

    @property
    def focal_length(self) -> float:
        """Normalized focal (principal point 0.5) — dataloader.py:55."""
        return float(0.5 / np.tan(0.5 * self.camera_angle_x))

    def __len__(self) -> int:
        return len(self.data)

    def __getitem__(self, idx: int) -> Dict:
        from PIL import Image  # only reading real png frames needs PIL

        img_path, pose = self.data[idx]
        image = (
            Image.open(img_path)
            .resize((self.img_size, self.img_size))
            .convert("RGB")
        )
        image = np.asarray(image, dtype=np.float32) / 255.0
        return {
            "image": image,
            "pose": pose,
            "focal_length": self.focal_length,
        }
