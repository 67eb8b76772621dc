"""Host-side dataset loading for the reference 360-VIO layout.

The port's own copy of ``vio360_tpu/io/dataset.py`` with the Python
decode path only (numpy / PIL; no native prefetch decoder)::

    dataset_dir/
      cam_timestamps.txt   one float seconds-timestamp per line
      imu_data.csv         optional: header + rows t,ax,ay,az,gx,gy,gz
      images/              sorted grayscale ERP frames (.png, .npy, ...)

Frames come out as float32 [H, W] in [0, 1] with the IMU rows of
[previous timestamp, timestamp).
"""

from __future__ import annotations

import csv
import dataclasses
import os
from collections.abc import Iterator

import numpy as np


@dataclasses.dataclass
class DatasetFrame:
    index: int
    timestamp: float
    image: np.ndarray  # [H, W] float32 in [0,1]
    imu: np.ndarray  # [M, 7] rows (t, ax, ay, az, gx, gy, gz) in [prev_t, t)


def load_camera_timestamps(path: str) -> np.ndarray:
    with open(path) as f:
        return np.asarray([float(ln) for ln in (s.strip() for s in f) if ln], dtype=np.float64)


def _is_numeric_row(row: list[str]) -> bool:
    try:
        [float(x) for x in row[:7]]
        return len(row) >= 7
    except (ValueError, IndexError):
        return False


def load_imu_csv(path: str) -> np.ndarray:
    """Header + 7 columns -> [M, 7] float64."""
    rows = []
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader, None)
        if header is not None and _is_numeric_row(header):
            rows.append([float(x) for x in header[:7]])
        for row in reader:
            if len(row) >= 7:
                rows.append([float(x) for x in row[:7]])
    return np.asarray(rows, dtype=np.float64).reshape(-1, 7)


_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".pgm", ".bmp", ".tif", ".tiff", ".npy")


def list_image_files(images_dir: str) -> list[str]:
    return [os.path.join(images_dir, f) for f in sorted(os.listdir(images_dir))
            if f.lower().endswith(_IMAGE_EXTS)]


def load_image_gray(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """Decode to float32 grayscale [H, W] in [0, 1]; optional resize to (W, H).
    ``.npy`` frames load without PIL."""
    if not path.endswith(".npy"):
        from PIL import Image

        with Image.open(path) as im:
            im = im.convert("L")
            if size is not None and im.size != size:
                im = im.resize(size, Image.BILINEAR)
            return np.asarray(im, dtype=np.float32) / 255.0
    img = np.load(path)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = np.asarray(img, dtype=np.float32)
    if size is not None and (img.shape[1], img.shape[0]) != size:
        from PIL import Image

        im = Image.fromarray((img * 255).astype(np.uint8))
        img = np.asarray(im.resize(size, Image.BILINEAR), dtype=np.float32) / 255.0
    return img


def slice_imu(imu: np.ndarray, t0: float, t1: float) -> np.ndarray:
    """IMU rows with t in [t0, t1)."""
    if imu.size == 0:
        return np.zeros((0, 7), dtype=np.float64)
    return imu[(imu[:, 0] >= t0) & (imu[:, 0] < t1)]


class VioDataset:
    """Iterates DatasetFrames of a reference-layout dataset directory."""

    def __init__(self, dataset_dir: str, image_size: tuple[int, int] | None = None):
        self.dir = dataset_dir
        self.timestamps = load_camera_timestamps(os.path.join(dataset_dir, "cam_timestamps.txt"))
        imu_path = os.path.join(dataset_dir, "imu_data.csv")
        self.imu = load_imu_csv(imu_path) if os.path.exists(imu_path) else np.zeros((0, 7))
        self.image_files = list_image_files(os.path.join(dataset_dir, "images"))
        self.image_size = image_size
        n = min(len(self.timestamps), len(self.image_files))
        self.timestamps = self.timestamps[:n]
        self.image_files = self.image_files[:n]

    def __len__(self) -> int:
        return len(self.image_files)

    def load_image(self, i: int) -> np.ndarray:
        return load_image_gray(self.image_files[i], self.image_size)

    def __iter__(self) -> Iterator[DatasetFrame]:
        prev_t = -np.inf
        for i, t in enumerate(self.timestamps):
            yield DatasetFrame(index=i, timestamp=float(t), image=self.load_image(i),
                               imu=slice_imu(self.imu, prev_t, t))
            prev_t = t
