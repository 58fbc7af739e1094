"""Vision datasets and federated partitions, a copy of
``breaching_tpu/cases/data/datasets_vision.py`` whose samples leave the dataset
in the port's CHW layout: images are built and augmented HWC as there, and
transposed once, after normalization.

The JAX package's module replaces the reference's torchvision-backed builders
(reference: breaching/cases/data/datasets_vision.py:20-148). Two backends:

1. On-disk data if present: CIFAR-10/100 python pickles under
   `<path>/cifar-10-batches-py` / `cifar-100-python`, a generic
   `<path>/<name>_<split>.npz` with arrays (images[N,H,W,C] uint8, labels[N]),
   or an ImageFolder tree (`<path>/{train,val}/<class>/*.{JPEG,png,...}`,
   the torchvision ImageNet/TinyImageNet layout) decoded lazily via PIL.
2. A deterministic *synthetic* backend otherwise (where no dataset is on
   disk): label-conditioned smooth random images, generated lazily
   per index so even ImageNet-shaped datasets cost nothing upfront.

Partition semantics mirror the reference `_split_dataset_vision`
(datasets_vision.py:84-148): balanced / unique-class / mixup / feat_est /
random-full / random (fixed generator seed 233) / none.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

_RANDOM_PARTITION_SEED = 233  # fixed in the reference for reproducible user splits


class VisionDataset:
    """A lazily-evaluated, normalized vision dataset restricted to an index set."""

    def __init__(self, cfg_data, split: str, indices=None):
        self.cfg = cfg_data
        self.name = cfg_data.name
        self.split = split
        self.mean = np.asarray(cfg_data.mean, np.float32) if cfg_data.normalize else np.zeros(3, np.float32)
        self.std = np.asarray(cfg_data.std, np.float32) if cfg_data.normalize else np.ones(3, np.float32)
        self.classes = [f"class_{i}" for i in range(cfg_data.classes)]

        from .transforms import parse_data_augmentations

        aug_key = "augmentations_train" if split == "training" else "augmentations_val"
        try:
            aug_cfg = getattr(cfg_data, aug_key)
        except (AttributeError, KeyError):
            aug_cfg = None
        self.transform = parse_data_augmentations(aug_cfg)

        self._raw = _load_real_data(cfg_data, split)
        if self._raw is not None:
            images, labels = self._raw
            self._size = len(labels)
            self._labels = labels.astype(np.int64)
        else:
            self._size = _synthetic_split_size(cfg_data, split)
            rng = np.random.default_rng(_stable_seed(self.name, split))
            per_class = -(-self._size // cfg_data.classes)
            self._labels = rng.permutation(
                np.tile(np.arange(cfg_data.classes, dtype=np.int64), per_class)[: self._size]
            )
        self.indices = np.arange(self._size) if indices is None else np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    @property
    def labels(self):
        """Labels of this dataset's view, in view order."""
        return self._labels[self.indices]

    def __getitem__(self, idx: int):
        gidx = int(self.indices[idx])
        if self._raw is not None:
            img = self._raw[0][gidx].astype(np.float32) / 255.0
        else:
            img = self._synthesize(gidx)
        # Config-driven augmentations (reference _parse_data_augmentations,
        # datasets_vision.py:200-221) run on the [0,1] image before
        # normalization. Validation transforms (Resize/CenterCrop) are only
        # needed when the backend hands back a non-target-shaped image (raw
        # npz); the lazy backends already produce target-shaped arrays, and
        # re-resizing those would only blur them.
        if self.transform is not None:
            _, h, w = self.cfg.shape
            if self.split == "training" or img.shape[:2] != (h, w):
                rng = np.random.default_rng(_stable_seed(self.name, self.split, gidx, "aug"))
                img = self.transform(img, rng)
        img = (img - self.mean) / self.std
        return dict(inputs=np.ascontiguousarray(img.transpose(2, 0, 1)), labels=self._labels[gidx])

    def _synthesize(self, gidx: int) -> np.ndarray:
        """Deterministic label-conditioned smooth image in [0, 1], HWC."""
        _, h, w = self.cfg.shape
        label = int(self._labels[gidx])
        rng = np.random.default_rng(_stable_seed(self.name, self.split, gidx))
        base = np.asarray(
            [((label * 37 + c * 11) % 97) / 97.0 for c in range(3)], np.float32
        )
        coarse = rng.uniform(0, 1, size=(8, 8, 3)).astype(np.float32)
        img = _bilinear_upsample(coarse, h, w)
        img = 0.55 * img + 0.35 * base[None, None, :] + 0.10 * rng.uniform(0, 1, (h, w, 3)).astype(np.float32)
        return np.clip(img, 0.0, 1.0)

    def subset(self, indices):
        view = VisionDataset.__new__(VisionDataset)
        view.__dict__.update(self.__dict__)
        view.indices = self.indices[np.asarray(indices)]
        return view


def _bilinear_upsample(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Pure-numpy bilinear resize for the synthetic generator."""
    src_h, src_w = img.shape[:2]
    ys = np.linspace(0, src_h - 1, h, dtype=np.float32)
    xs = np.linspace(0, src_w - 1, w, dtype=np.float32)
    y0, x0 = np.floor(ys).astype(int), np.floor(xs).astype(int)
    y1, x1 = np.minimum(y0 + 1, src_h - 1), np.minimum(x0 + 1, src_w - 1)
    wy, wx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _stable_seed(*parts) -> int:
    h = 2166136261
    for part in parts:
        for b in str(part).encode():
            h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return h


def _synthetic_split_size(cfg_data, split: str) -> int:
    if split == "training":
        return min(int(cfg_data.size), 50_000)
    # validation splits: 10k for CIFAR-scale data, 50 per class capped at 50k otherwise
    return min(max(int(cfg_data.classes) * 50, 10_000), 50_000)


def _load_real_data(cfg_data, split: str):
    """Look for real data on disk; return (images_uint8[N,H,W,C], labels) or None."""
    root = os.path.expanduser(str(cfg_data.path))
    name = cfg_data.name.lower()
    npz_path = os.path.join(root, f"{cfg_data.name}_{split}.npz")
    if os.path.exists(npz_path):
        blob = np.load(npz_path)
        return blob["images"], blob["labels"]
    if name == "cifar10":
        return _load_cifar_pickles(os.path.join(root, "cifar-10-batches-py"), split, fine=False)
    if name == "cifar100":
        return _load_cifar_pickles(os.path.join(root, "cifar-100-python"), split, fine=True)
    if name == "tinyimagenet":
        loaded = _load_tiny_imagenet(cfg_data, split)
        if loaded is not None:
            return loaded
    return _load_image_folder(cfg_data, split)


_SPLIT_DIRS = {"training": ("train", "training"), "validation": ("val", "validation", "test")}
_IMG_EXTS = (".jpeg", ".jpg", ".png", ".bmp", ".webp")


class _ImageFolder:
    """Lazy ImageFolder backend (torchvision layout: `<split>/<class>/img`).

    Replaces the reference's torchvision ImageNet/TinyImageNet builders
    (reference datasets_vision.py:60-83) without materializing the dataset:
    paths are indexed once, images are decoded + resized per access, so an
    ImageNet-sized tree costs nothing upfront. Resize follows the reference
    eval transform: shorter-side resize to ~1.14x target then center crop.
    """

    def __init__(self, samples, shape):
        self.samples = samples  # list of file paths, class-sorted
        self.shape = shape  # (C, H, W) from the data config

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        from PIL import Image

        _, h, w = self.shape
        with Image.open(self.samples[idx]) as im:
            im = im.convert("RGB")
            if (im.height, im.width) == (h, w):  # already target-sized
                return np.asarray(im, dtype=np.uint8)
            scale = max(h / im.height, w / im.width) * 1.14
            if abs(scale - 1.0) > 1e-3:
                im = im.resize((max(w, round(im.width * scale)),
                                max(h, round(im.height * scale))), Image.BILINEAR)
            left, top = (im.width - w) // 2, (im.height - h) // 2
            im = im.crop((left, top, left + w, top + h))
            return np.asarray(im, dtype=np.uint8)


def _load_image_folder(cfg_data, split: str):
    root = os.path.expanduser(str(cfg_data.path))
    candidates = []
    for split_dir in _SPLIT_DIRS.get(split, (split,)):
        candidates.append(os.path.join(root, split_dir))
        candidates.append(os.path.join(root, cfg_data.name, split_dir))
    folder = next((c for c in candidates if os.path.isdir(c)), None)
    if folder is None:
        return None
    class_dirs = sorted(d for d in os.listdir(folder)
                        if os.path.isdir(os.path.join(folder, d)))
    if not class_dirs:
        return None
    samples, labels = [], []
    for cls_idx, cls in enumerate(class_dirs[: int(cfg_data.classes)]):
        cls_path = os.path.join(folder, cls)
        for fname in sorted(os.listdir(cls_path)):
            if fname.lower().endswith(_IMG_EXTS):
                samples.append(os.path.join(cls_path, fname))
                labels.append(cls_idx)
    if not samples:
        return None
    return _ImageFolder(samples, cfg_data.shape), np.asarray(labels, np.int64)


def _load_tiny_imagenet(cfg_data, split: str):
    """The tiny-imagenet-200 zip layout (reference datasets_vision.py:224-350;
    the download path is env-bound — unzip `tiny-imagenet-200.zip` under
    cfg.data.path): `train/<wnid>/images/<wnid>_<n>.JPEG`, `val/images/*` with
    `val/val_annotations.txt`, labels = index into *sorted* wnids.txt."""
    import glob as _glob

    root = os.path.expanduser(str(cfg_data.path))
    folder = next((c for c in (os.path.join(root, "tiny-imagenet-200"), root)
                   if os.path.isfile(os.path.join(c, "wnids.txt"))), None)
    if folder is None:
        return None
    with open(os.path.join(folder, "wnids.txt")) as fh:
        wnid_to_label = {w: i for i, w in enumerate(sorted(line.strip() for line in fh if line.strip()))}

    split_dir = os.path.join(folder, {"training": "train", "validation": "val"}.get(split, split))
    samples = sorted(_glob.iglob(os.path.join(split_dir, "**", "*.JPEG"), recursive=True))
    if not samples:
        return None
    if os.path.basename(split_dir) == "val":
        file_to_label = {}
        with open(os.path.join(split_dir, "val_annotations.txt")) as fh:
            for line in fh:
                terms = line.split("\t")
                file_to_label[terms[0]] = wnid_to_label[terms[1]]
        labels = [file_to_label[os.path.basename(p)] for p in samples]
    else:  # train files are named <wnid>_<n>.JPEG
        labels = [wnid_to_label[os.path.basename(p).rsplit("_", 1)[0]] for p in samples]
    return _ImageFolder(samples, cfg_data.shape), np.asarray(labels, np.int64)


def _load_cifar_pickles(folder: str, split: str, fine: bool):
    if not os.path.isdir(folder):
        return None
    if fine:
        files = ["train"] if split == "training" else ["test"]
        label_key = b"fine_labels"
    else:
        files = [f"data_batch_{i}" for i in range(1, 6)] if split == "training" else ["test_batch"]
        label_key = b"labels"
    images, labels = [], []
    for fname in files:
        path = os.path.join(folder, fname)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as fh:
            entry = pickle.load(fh, encoding="bytes")
        data = entry[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        images.append(data)
        labels.append(np.asarray(entry[label_key]))
    return np.concatenate(images), np.concatenate(labels)


# ---------------------------------------------------------------------------
# Federated partitions (reference: datasets_vision.py:84-148)
# ---------------------------------------------------------------------------

def measure_mean_std(dataset, max_items=None):
    """Per-channel mean and standard deviation of the un-normalized pixels of a
    dataset, by a parallel Welford merge over its images (reference: _get_meanstd,
    datasets_vision.py:178-197): the tool that calibrates a data config's mean and std
    from a dataset on disk. Returns two lists of floats."""
    mean = np.zeros(3, np.float64)
    m2 = np.zeros(3, np.float64)
    n = 0
    count = len(dataset) if max_items is None else min(len(dataset), max_items)
    channel = (-1, 1, 1)
    for i in range(count):
        sample = dataset[i]["inputs"]  # CHW, normalized by the view
        pixels = np.asarray(sample, np.float64) * dataset.std.reshape(channel) + dataset.mean.reshape(channel)
        pixels = pixels.reshape(pixels.shape[0], -1)
        n_b = pixels.shape[1]
        dm = pixels.mean(axis=1)
        ds = pixels.var(axis=1, ddof=1)
        n_a, n = n, n + n_b
        delta = dm - mean
        mean += delta * n_b / n
        m2 += ds * (n_b - 1) + delta ** 2 * n_a * n_b / n
    return mean.tolist(), np.sqrt(m2 / max(n - 1, 1)).tolist()


def split_dataset(dataset: VisionDataset, cfg_data, user_idx: int, return_full_dataset=False):
    if return_full_dataset:
        return dataset
    num_users = int(cfg_data.default_clients)
    partition = cfg_data.partition
    labels = dataset._labels[dataset.indices]

    if partition == "balanced":
        if user_idx >= num_users:
            raise ValueError(f"user_idx {user_idx} exceeds the {num_users} balanced users.")
        keep = []
        for cls in range(cfg_data.classes):
            cls_idx = np.nonzero(labels == cls)[0]
            per_user = len(cls_idx) // num_users
            keep.append(cls_idx[user_idx * per_user:(user_idx + 1) * per_user])
        indices = np.sort(np.concatenate(keep))
    elif partition == "unique-class":
        if user_idx >= cfg_data.classes:
            raise ValueError(f"unique-class partition supports at most {cfg_data.classes} users.")
        indices = np.nonzero(labels == user_idx)[0]
    elif partition == "mixup":
        # interleave each user's chunk with its mirror from the end
        # (reference: datasets_vision.py:107-119)
        per_user = len(labels) // num_users
        last = len(labels) - 1
        pairs = []
        for i in range(per_user):
            pairs.append(user_idx * per_user + i)
            pairs.append(last - user_idx * per_user - i)
        indices = np.asarray(pairs)
    elif partition == "feat_est":
        # chunks of one target class across users, for the fishing server's
        # feature-estimation protocol (reference: datasets_vision.py:120-133)
        target = int(cfg_data.get("target_label", 0) or 0)
        points = int(cfg_data.get("num_data_points", 1) or 1)
        cls_idx = np.nonzero(labels == target)[0]
        indices = cls_idx[user_idx * points:(user_idx + 1) * points]
        if len(indices) == 0:
            raise ValueError("Not enough data for feat_est user.")
    elif partition == "random-full":
        rng = np.random.default_rng(_RANDOM_PARTITION_SEED + user_idx)
        indices = rng.permutation(len(labels))
    elif partition == "random":
        rng = np.random.default_rng(_RANDOM_PARTITION_SEED)
        order = rng.permutation(len(labels))
        per_user = len(labels) // num_users
        if user_idx >= num_users:
            raise ValueError(f"user_idx {user_idx} exceeds the {num_users} random users.")
        indices = np.sort(order[user_idx * per_user:(user_idx + 1) * per_user])
    elif partition in (None, "none"):
        indices = np.arange(len(labels))
    else:
        raise ValueError(f"Unknown partition scheme {partition}.")
    if len(indices) == 0:
        raise ValueError(f"User {user_idx} would receive no data under partition {partition}.")
    return dataset.subset(indices)
