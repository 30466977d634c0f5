"""PartNet dataset: category registry, h5 loading, splits, augmentation.

Port of `MinkowskiNet/lib/datasets/partnet.py` + the h5 prefetch logic of
`lib/dataset.py:104-146`. Data format: per-split h5 files listed in
`{train,val,test}_files.txt`, each with `data` [N, P, 3] float points and
`label_seg` [N, P] int labels.

The dataset prefetches every shape into RAM (the reference requires
`--prefetch_data True`, `lib/dataset.py:118-119`), optionally normalizes each
shape into the unit sphere/box, and serves (coords, feats, labels) numpy
triples with on-the-fly augmentation; batching/voxelization happens in
`data/pipeline.py` + `core/pyramid.py`.

The port's own copy of `csn_tpu/data/partnet.py` (no JAX in either).
"""

from __future__ import annotations

import enum
import os
from typing import List, Optional, Tuple

import numpy as np

from csn_tpu_torch.data import transforms as T

# `lib/datasets/partnet.py:11-27`
NUM_SEG = {
    "Bed": 15, "Bottle": 9, "Chair": 39, "Clock": 11, "Dishwasher": 7,
    "Display": 4, "Door": 5, "Earphone": 10, "Faucet": 12, "Knife": 10,
    "Lamp": 41, "Microwave": 6, "Refrigerator": 7, "StorageFurniture": 24,
    "Table": 51, "TrashCan": 11, "Vase": 6,
}

CATEGORIES = tuple(sorted(NUM_SEG))

# Training-set sizes per category (`scripts/training_csn.sh:5`), used for
# stat_freq / max_iter derivation in the shell wrappers.
TRAIN_COUNTS = {
    "Bed": 133, "Bottle": 315, "Chair": 4489, "Clock": 406, "Dishwasher": 111,
    "Display": 633, "Door": 149, "Earphone": 147, "Faucet": 435, "Knife": 221,
    "Lamp": 1554, "Microwave": 133, "Refrigerator": 136,
    "StorageFurniture": 1588, "Table": 5707, "TrashCan": 221, "Vase": 741,
}


class DatasetPhase(enum.Enum):
    """`lib/dataset.py:21-27`."""

    Train = 0
    Val = 1
    Val2 = 2
    TrainVal = 3
    Test = 4


def str2phase(arg: str) -> DatasetPhase:
    try:
        return {"train": DatasetPhase.Train, "val": DatasetPhase.Val,
                "val2": DatasetPhase.Val2, "trainval": DatasetPhase.TrainVal,
                "test": DatasetPhase.Test}[arg.lower()]
    except KeyError:
        raise ValueError("phase must be one of train/val/test")


PHASE_FILES = {
    DatasetPhase.Train: "train_files.txt",
    DatasetPhase.Val: "val_files.txt",
    DatasetPhase.Test: "test_files.txt",
}


def read_txt(path: str) -> List[str]:
    with open(path) as f:
        return [x.strip() for x in f.readlines()]


class PartnetDataset:
    """In-memory PartNet split for one category.

    Augmentation bounds from `lib/datasets/partnet.py:36-40`; voxel size is a
    property of the *pyramid spec*, not the dataset (the dataset serves world
    coords; `core/pyramid.py` scales by 1/voxel_size like `lib/voxelizer.py`).
    """

    ROTATION_AUGMENTATION_BOUND = (-5 * np.pi / 180.0, 5 * np.pi / 180.0)
    JITTER_AUGMENTATION_BOUND = (0.25, 0.25, 0.25)
    SCALE_AUGMENTATION_BOUND = (0.75, 1.25)
    SHIFT_PARAMS = (0.01, 0.05)

    def __init__(
        self,
        data_root: Optional[str],
        category: str,
        phase: DatasetPhase | str = DatasetPhase.Train,
        normalize: bool = True,
        normalize_method: str = "sphere",
        input_feat: str = "xyz",
        augment: Optional[T.Compose] = None,
        ignore_label: int = 255,
    ):
        if isinstance(phase, str):
            phase = str2phase(phase)
        self.category = category
        self.phase = phase
        self.num_labels = NUM_SEG[category.split("-")[0]]
        self.ignore_label = ignore_label
        self.input_feat = input_feat.lower()
        if self.input_feat != "xyz":
            raise ValueError(f"Unknown input features {self.input_feat}")
        self.augment = augment
        self.coords: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []
        # kNN shape-graph slots (`lib/dataset.py:125-126`)
        self.neighbors: List[Tuple[int, List[int]]] = []

        if data_root is None:   # no files: `from_arrays` adds the shapes
            return
        root = os.path.join(data_root, category)
        files = read_txt(os.path.join(root, PHASE_FILES[phase]))
        import h5py

        for fn in files:
            with h5py.File(os.path.join(root, fn), "r") as f:
                self._add_shapes(f["data"][:], f["label_seg"][:], normalize,
                                 normalize_method)

    def _add_shapes(self, data, segs, normalize: bool,
                    normalize_method: str) -> None:
        """Append the shapes of `data` [N, P, 3] and `label_seg` [N, P] (one
        h5 file's arrays), normalized as the constructor says."""
        data = np.asarray(data).astype(np.float32)
        segs = np.asarray(segs).astype(np.int32)
        for i in range(data.shape[0]):
            c = data[i]
            if normalize:
                c = T.normalize_coords(c, normalize_method)
            self.coords.append(c.astype(np.float32))
            self.labels.append(segs[i].reshape(-1))
            self.neighbors.append((len(self.coords) - 1, []))

    @classmethod
    def from_arrays(cls, data, label_seg, category: str,
                    phase: DatasetPhase | str = DatasetPhase.Train
                    ) -> "PartnetDataset":
        """The split (default normalization, no augmentation) that an h5
        file holding `data` [N, P, 3] and `label_seg` [N, P] would give,
        built in memory (no h5py)."""
        ds = cls(None, category, phase)
        ds._add_shapes(data, label_seg, True, "sphere")
        return ds

    def __len__(self) -> int:
        return len(self.coords)

    @property
    def num_points(self) -> int:
        return max(c.shape[0] for c in self.coords)

    def get(self, index: int, rng: Optional[np.random.Generator] = None,
            augment: bool = True):
        """Returns (coords [P,3], feats [P,3], labels [P]).

        Input features are the (augmented, normalized) world coordinates —
        the reference's AUGMENT_COORDS_TO_FEATS path
        (`lib/dataset.py:212-219,237-238`)."""
        coords = np.copy(self.coords[index])
        labels = np.copy(self.labels[index])
        feats = coords.copy()
        if augment and self.augment is not None and rng is not None:
            coords, feats, labels = self.augment(coords, feats, labels, rng)
            feats = coords.copy()  # xyz features track augmented coords
        return coords, feats, labels


def make_partnet_dataset(
    data_root: str,
    category: str,
    phase: str,
    *,
    distort: bool = False,
    normalize: bool = True,
    normalize_method: str = "sphere",
) -> PartnetDataset:
    """`--distort_partnet` macro-flag (`lib/config.py:147-152`): rotation +
    jitter + scale augmentation for the train split."""
    augment = None
    if distort and phase == "train":
        augment = T.build_prevoxel_transforms(
            PartnetDataset, rot_aug=True, jitter=True, scale=True)
    return PartnetDataset(
        data_root, category, phase, normalize=normalize,
        normalize_method=normalize_method, augment=augment)


def write_synthetic_partnet(
    root: str,
    category: str = "Chair",
    n_train: int = 8,
    n_val: int = 4,
    n_test: int = 4,
    num_points: int = 256,
    num_labels: Optional[int] = None,
    seed: int = 0,
):
    """Create a tiny synthetic PartNet-format dataset (test fixture;
    SURVEY.md §4 'integration tests on synthetic mini-PartNet h5 fixtures')."""
    import h5py

    rng = np.random.default_rng(seed)
    num_labels = num_labels or NUM_SEG.get(category, 8)
    cat_dir = os.path.join(root, category)
    os.makedirs(cat_dir, exist_ok=True)
    for phase, n in [("train", n_train), ("val", n_val), ("test", n_test)]:
        fn = f"{phase}-00.h5"
        with h5py.File(os.path.join(cat_dir, fn), "w") as f:
            pts = rng.uniform(-1, 1, size=(n, num_points, 3)).astype(np.float32)
            # labels correlated with geometry so training can learn something
            labs = (
                (pts[..., 0] > 0).astype(np.int32)
                + 2 * (pts[..., 1] > 0).astype(np.int32)
            ) % max(num_labels - 1, 1) + 1
            zero_mask = rng.random((n, num_points)) < 0.05
            labs = np.where(zero_mask, 0, labs)
            f.create_dataset("data", data=pts)
            f.create_dataset("label_seg", data=labs)
        with open(os.path.join(cat_dir, f"{phase}_files.txt"), "w") as f:
            f.write(fn + "\n")
    return cat_dir
