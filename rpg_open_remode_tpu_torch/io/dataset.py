"""Loader for the REMODE evaluation-dataset format (the port's copy of
``rpg_open_remode_tpu/io/dataset.py``, which imports nothing of JAX either).

Byte-compatible with the reference's ``rmd::test::Dataset``
(test/dataset.cpp), so the public ``traj_over_table`` dataset used by the
reference's offline benchmark (test/dataset_main.cpp) works verbatim:

  - sequence file: one entry per line,
    ``<image-file> tx ty tz qx qy qz qw`` (dataset.cpp:94-117); the pose is
    ``T_world_curr`` (dataset_main.cpp:89 inverts it before use)
  - images:    ``<root>/images/<image-file>`` (grayscale)
  - GT depth:  ``<root>/depthmaps/<stem>.depth`` — H*W whitespace-separated
    ASCII floats in centimetres, divided by 100 on load
    (dataset.cpp:104-105,159-186)
  - dataset root from the ``RMD_TEST_DATA_PATH`` env var
    (dataset.cpp:199-208)

The ASCII depth parse goes through the port's native C++ runtime when it
builds (~2.5 MB of text per 640x480 frame), else its numpy version.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
from pathlib import Path

import numpy as np

from rpg_open_remode_tpu_torch import native

DATA_PATH_ENV_VAR = "RMD_TEST_DATA_PATH"


def quat_to_rotation(w: float, x: float, y: float, z: float) -> np.ndarray:
    """Unit-quaternion -> 3x3 rotation, same formula as SE3's quaternion
    ctor (include/rmd/se3.cuh:38-66)."""
    n = np.sqrt(w * w + x * x + y * y + z * z)
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        np.float32,
    )


@dataclasses.dataclass
class DatasetEntry:
    image_file: str
    depthmap_file: str
    translation: np.ndarray   # [3] t of T_world_curr
    quaternion: np.ndarray    # [4] (x, y, z, w)

    @property
    def T_world_curr(self) -> np.ndarray:
        """(3, 4) camera-to-world pose."""
        qx, qy, qz, qw = self.quaternion
        R = quat_to_rotation(qw, qx, qy, qz)
        return np.concatenate([R, self.translation.reshape(3, 1)], axis=1)

    @property
    def T_curr_world(self) -> np.ndarray:
        """(3, 4) world-to-camera — what Depthmap.set_reference_image /
        update expect (the inversion done at test/dataset_main.cpp:89,102)."""
        qx, qy, qz, qw = self.quaternion
        R = quat_to_rotation(qw, qx, qy, qz)
        t = self.translation.astype(np.float32)
        return np.concatenate([R.T, (-R.T @ t).reshape(3, 1)], axis=1)


def read_gray_image(path: str) -> np.ndarray:
    """Grayscale uint8 [H, W] from any image file (native reader for PGM;
    PIL, imported here, for other formats) — shared by the dataset loader
    and the CLI's live stdin input."""
    if path.lower().endswith(".pgm"):
        return native.read_pgm(path)
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


class Dataset:
    """Sequence + images + GT depthmaps, reference on-disk layout."""

    def __init__(self, sequence_file: str, path: str | None = None):
        self.sequence_file = sequence_file
        self.path = Path(path) if path else None
        self.entries: list[DatasetEntry] = []

    def load_path_from_env(self) -> bool:
        env = os.environ.get(DATA_PATH_ENV_VAR)
        if env:
            self.path = Path(env)
            return True
        return False

    def read_data_sequence(self, start: int = 0, end: int = 0) -> bool:
        """Parse the sequence file; [start, end) line window, end=0 = all
        (dataset.cpp:86-127)."""
        seq_path = self.path / self.sequence_file
        if not seq_path.is_file():
            return False
        self.entries = []
        with open(seq_path) as f:
            for line_cnt, line in enumerate(f):
                if line_cnt < start or (end != 0 and line_cnt >= end):
                    continue
                parts = line.split()
                if len(parts) < 8:
                    continue
                name = parts[0]
                stem = name.split(".")[0]
                self.entries.append(
                    DatasetEntry(
                        image_file=name,
                        depthmap_file=stem + ".depth",
                        translation=np.array(parts[1:4], np.float32),
                        quaternion=np.array(parts[4:8], np.float32),
                    )
                )
        return True

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> DatasetEntry:
        return self.entries[i]

    def __iter__(self):
        return iter(self.entries)

    def read_image(self, entry: DatasetEntry) -> np.ndarray:
        """Grayscale uint8 [H, W] (dataset.cpp:130-139)."""
        return read_gray_image(str(self.path / "images" / entry.image_file))

    def read_depthmap(self, entry: DatasetEntry, width: int, height: int) -> np.ndarray:
        """GT depth in metres, float32 [H, W] (dataset.cpp:159-186:
        ASCII centimetres / 100)."""
        p = self.path / "depthmaps" / entry.depthmap_file
        vals = native.parse_float_file(str(p), width * height, scale=0.01)
        return vals.reshape(height, width)


class FramePrefetcher:
    """Bounded read-ahead of ``(entry, image, gt_depth)`` on a worker thread.

    The reference's benchmark loop reads each frame from disk synchronously
    inside the timed loop (test/dataset_main.cpp:101-109). Here the decode
    (native PGM / ASCII-depth parsers, which release the GIL) overlaps the
    main thread's device dispatch, so a replay is never IO-bound on a real
    host. ``depth`` bounds the queue, capping read-ahead memory at
    ``depth`` frames. Worker exceptions re-raise in the consumer.

    Usage::

        for entry, img, gt in FramePrefetcher(ds, gt_shape=(w, h)):
            engine.update(img, entry.T_curr_world)
    """

    _DONE = object()

    def __init__(self, ds: Dataset, entries=None, depth: int = 4,
                 gt_shape=None):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._t = threading.Thread(
            target=self._worker,
            args=(ds, list(ds if entries is None else entries), gt_shape),
            daemon=True,
        )
        self._t.start()

    def _worker(self, ds, entries, gt_shape):
        try:
            for e in entries:
                if self._stop.is_set():
                    break
                img = ds.read_image(e)
                gt = None
                if gt_shape is not None:
                    try:
                        gt = ds.read_depthmap(e, gt_shape[0], gt_shape[1])
                    except (FileNotFoundError, ValueError):
                        gt = None
                self._q.put((e, img, gt))
            self._q.put(self._DONE)
        except BaseException as ex:  # re-raised in the consumer
            self._q.put(ex)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def close(self):
        """Stop the worker and drain the queue (safe mid-iteration)."""
        self._stop.set()
        while self._t.is_alive():
            try:
                self._q.get_nowait()
            except queue.Empty:
                self._t.join(timeout=0.1)
        self._t.join()
