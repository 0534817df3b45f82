"""Dataset loaders: Kodak / CLIC2020 / Tecnick with a synthetic fallback,
the bundled real images, and the training crop iterator.

An own numpy copy of tpucdc/data/datasets.py: the same seeds, the same
environment variables, the same arrays. A loader reads a local directory
when one is present (its environment variable, ``~/data/<name>`` or
``./data/<name>``) and otherwise falls back to a deterministic synthetic set,
flagged by ``EvalDataset.synthetic``; R-D numbers on synthetic data compare
only with themselves. Pillow is imported only by the functions that read
image files.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import pathlib
import sysconfig
from typing import Iterator

import numpy as np


def _stable_seed(name: str) -> int:
    """PYTHONHASHSEED-independent 31-bit seed: the built-in hash() is
    randomized per process."""
    return int.from_bytes(hashlib.sha256(name.encode()).digest()[:4],
                          "little") & 0x7FFFFFFF

_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm")

_HOME_DATA = pathlib.Path.home() / "data"

_SPECS = {
    "kodak": ("TPUCDC_KODAK_DIR", [_HOME_DATA / "kodak", "./data/kodak"],
              24, (512, 768)),
    "clic2020": ("TPUCDC_CLIC_DIR",
                 [_HOME_DATA / "clic2020", "./data/clic2020"],
                 8, (1024, 1536)),
    "tecnick": ("TPUCDC_TECNICK_DIR",
                [_HOME_DATA / "tecnick", "./data/tecnick"],
                8, (1200, 1200)),
}


@dataclasses.dataclass
class EvalDataset:
    name: str
    images: list[np.ndarray]          # HWC uint8
    synthetic: bool

    def __len__(self):
        return len(self.images)

    def __iter__(self):
        return iter(self.images)


def _load_dir(path: pathlib.Path) -> list[np.ndarray]:
    from PIL import Image
    files = sorted(p for p in path.iterdir() if p.suffix.lower() in _EXTS)
    return [np.asarray(Image.open(f).convert("RGB")) for f in files]


def synthetic_images(n: int, h: int, w: int, seed: int = 0) -> list[np.ndarray]:
    """Deterministic natural-image-like synthetics: smooth multi-scale fields
    plus edges — compressible and non-trivial for the codec."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        img = np.zeros((h, w, 3), np.float64)
        for scale in (4, 8, 16, 32):
            base = rng.normal(size=(max(h // scale, 1), max(w // scale, 1), 3))
            img += np.kron(base, np.ones((scale, scale, 1)))[:h, :w] / scale
        # Hard edges: random rectangles.
        for _ in range(6):
            i0, j0 = rng.integers(0, h), rng.integers(0, w)
            di, dj = rng.integers(h // 8, h // 2), rng.integers(w // 8, w // 2)
            img[i0:i0 + di, j0:j0 + dj] += rng.normal(scale=0.3, size=(3,))
        img = (img - img.min()) / (np.ptp(img) + 1e-9)
        out.append((img * 255).astype(np.uint8))
    return out


# Real photographs and textures that installed packages bundle, found under
# the interpreter's site-packages. Existence-gated: the corpus shrinks if a
# package is absent.
_SITE = sysconfig.get_paths()["purelib"]
_BUNDLED_REAL = {
    # name: (relative path, holdout?)  — holdouts are eval-only, never trained.
    "china": ("sklearn/datasets/images/china.jpg", True),
    "flower": ("sklearn/datasets/images/flower.jpg", False),
    "grace_hopper": ("matplotlib/mpl-data/sample_data/grace_hopper.jpg", True),
    "wood": ("gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/"
             "textures/wood1.png", False),
    "skin": ("gymnasium_robotics/envs/assets/adroit_hand/resources/textures/"
             "skin.png", False),
    "marble2": ("gymnasium_robotics/envs/assets/kitchen_franka/"
                "kitchen_assets/textures/white_marble_tile2.png", False),
    "marble": ("gymnasium_robotics/envs/assets/kitchen_franka/kitchen_assets/"
               "textures/white_marble_tile.png", True),
    "darkwood": ("gymnasium_robotics/envs/assets/adroit_hand/resources/"
                 "textures/darkwood.png", False),
    "silver": ("gymnasium_robotics/envs/assets/adroit_hand/resources/"
               "textures/silverRaw.png", False),
    "dogskin": ("dm_control/suite/dog_assets/skin_texture.png", False),
    "skybox": ("dm_control/locomotion/arenas/assets/outdoor_natural/"
               "OutdoorSkybox2048.png", False),
    "grass": ("dm_control/locomotion/arenas/assets/outdoor_natural/"
              "OutdoorGrassFloorD.png", False),
}


def local_image_corpus(split: str = "train") -> list[np.ndarray]:
    """Real bundled images: split="train" | "holdout" | "all".

    The holdout set (china / grace_hopper / marble) is reserved for R-D eval,
    so that trained weights are measured on images they never saw."""
    from PIL import Image
    out = []
    for _, (rel, holdout) in sorted(_BUNDLED_REAL.items()):
        if split == "train" and holdout:
            continue
        if split == "holdout" and not holdout:
            continue
        p = pathlib.Path(_SITE) / rel
        if p.exists():
            out.append(np.asarray(Image.open(p).convert("RGB")))
    return out


def synthetic_images_rich(n: int, h: int, w: int,
                          seed: int = 0) -> list[np.ndarray]:
    """Texture-rich synthetics: oriented gratings, fine noise texture and
    colour gradients over smooth fields, so that bits stay worth spending
    (smooth fields alone let the rate term collapse in R-D training)."""
    rng = np.random.default_rng(seed)
    out = []
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for _ in range(n):
        img = np.zeros((h, w, 3), np.float64)
        # multi-scale smooth fields
        for scale in (8, 16, 32, 64):
            base = rng.normal(size=(max(h // scale, 1), max(w // scale, 1), 3))
            img += np.kron(base, np.ones((scale, scale, 1)))[:h, :w] / 2.5
        # oriented sinusoidal gratings in random color directions
        for _ in range(rng.integers(2, 5)):
            th = rng.uniform(0, np.pi)
            freq = rng.uniform(0.05, 0.45)
            phase = rng.uniform(0, 2 * np.pi)
            grating = np.sin(freq * (np.cos(th) * xx + np.sin(th) * yy)
                             + phase)
            color = rng.normal(scale=0.35, size=(3,))
            mask_c = rng.integers(0, h), rng.integers(0, w)
            r = rng.integers(min(h, w) // 6, min(h, w))
            mask = ((yy - mask_c[0]) ** 2 + (xx - mask_c[1]) ** 2) < r * r
            img += grating[..., None] * color * mask[..., None]
        # hard-edged rectangles with contrasting borders
        for _ in range(6):
            i0, j0 = rng.integers(0, h), rng.integers(0, w)
            di = rng.integers(h // 8, h // 2)
            dj = rng.integers(w // 8, w // 2)
            img[i0:i0 + di, j0:j0 + dj] += rng.normal(scale=0.4, size=(3,))
        # fine noise texture patch (incompressible region)
        i0, j0 = rng.integers(0, max(h - h // 4, 1)), rng.integers(
            0, max(w - w // 4, 1))
        img[i0:i0 + h // 4, j0:j0 + w // 4] += rng.normal(
            scale=0.25, size=(h // 4, w // 4, 3))
        # global color gradient
        img += (yy[..., None] / h - 0.5) * rng.normal(scale=0.3, size=(3,))
        img = (img - img.min()) / (np.ptp(img) + 1e-9)
        out.append((img * 255).astype(np.uint8))
    return out


def training_corpus(n_synthetic: int = 48, size: int = 384,
                    seed: int = 11) -> list[np.ndarray]:
    """The training mix: every bundled real image of the train split plus
    texture-rich synthetics."""
    return local_image_corpus("train") + synthetic_images_rich(
        n_synthetic, size, size, seed=seed)


def eval_dataset(name: str) -> EvalDataset:
    env, paths, n_synth, (h, w) = _SPECS[name]
    cand = [os.environ.get(env)] + [str(p) for p in paths]
    for p in cand:
        if p and pathlib.Path(p).is_dir():
            imgs = _load_dir(pathlib.Path(p))
            if imgs:
                return EvalDataset(name, imgs, synthetic=False)
    return EvalDataset(name, synthetic_images(n_synth, h, w,
                                              seed=_stable_seed(name)),
                       synthetic=True)


def kodak() -> EvalDataset:
    return eval_dataset("kodak")


def clic2020() -> EvalDataset:
    return eval_dataset("clic2020")


def tecnick() -> EvalDataset:
    return eval_dataset("tecnick")


def usable_images(images: list[np.ndarray], crop: int) -> list[np.ndarray]:
    """The images at least ``crop`` pixels on both sides; raises if none."""
    usable = [im for im in images
              if im.shape[0] >= crop and im.shape[1] >= crop]
    if not usable:
        raise ValueError(f"no images at least {crop}px on both sides")
    return usable


def crop_batch(usable: list[np.ndarray], batch_size: int, crop: int,
               seed: int, batch_idx: int, as_uint8: bool = False
               ) -> np.ndarray:
    """Batch ``batch_idx``: random crops and flips drawn from a generator
    seeded with (seed, batch_idx); [-1, 1] f32, or the raw uint8."""
    rng = np.random.default_rng((seed, batch_idx))
    out = np.empty((batch_size, crop, crop, 3),
                   np.uint8 if as_uint8 else np.float32)
    for b in range(batch_size):
        im = usable[rng.integers(len(usable))]
        i = rng.integers(im.shape[0] - crop + 1)
        j = rng.integers(im.shape[1] - crop + 1)
        patch = im[i:i + crop, j:j + crop]
        if rng.random() < 0.5:
            patch = patch[:, ::-1]
        out[b] = patch if as_uint8 else (
            patch.astype(np.float32) / 127.5 - 1.0)
    return out


def train_crop_iterator(images: list[np.ndarray], batch_size: int,
                        crop: int, seed: int = 0,
                        as_uint8: bool = False,
                        start: int = 0) -> Iterator[np.ndarray]:
    """Infinite iterator of random-crop + flip batches in [-1, 1] f32.

    Deterministic given (images, seed) and resumable by step count: each
    batch's generator is seeded with (seed, batch index), so ``start=N``
    (a run resumed at step N) gives the stream from batch N exactly.

    ``as_uint8`` yields raw uint8 batches, for a train step that converts
    to [-1, 1] f32 on the device: 4× fewer bytes to the card per step.
    """
    usable = usable_images(images, crop)
    batch_idx = start
    while True:
        yield crop_batch(usable, batch_size, crop, seed, batch_idx, as_uint8)
        batch_idx += 1
