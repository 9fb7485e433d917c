"""Procedural surveillance-video generator (numpy, deterministic).

Replaces the paper's 170h of YouTube-live streams with reproducible synthetic
footage: each camera has a static background, a context (class mix — the
"scene"), and a periodic busy profile.  Object sprites are class-specific
textures moving linearly; ground truth (class, box) is known exactly, which
lets the benchmarks score accuracy without a human-labeled dataset.

Classes (12): 0 background-noise, 1 car, 2 person, 3 moped, 4 bus, 5 bike,
6 truck, 7 dog, 8 cart, 9 van, 10 scooter, 11 tractor.  'moped' (3) is the
paper's example query object.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

NUM_CLASSES = 12
QUERY_CLASS = 3          # moped, as in the paper
SPRITE = 16              # sprite side (pixels)
CAMERA_FIELD_W = 128     # world width (px) each camera's field of view
#                          covers on the 1-D camera chain the trajectory
#                          ground truth (scenario._track_substream) uses —
#                          matches CameraSpec.width, so object speeds in
#                          px/s mean the same thing in both worlds


def _class_texture(cls: int, size: int = SPRITE) -> np.ndarray:
    """Deterministic, distinctive texture per class: oriented gratings +
    class-coloured base — separable by a small classifier but not trivial."""
    rng = np.random.default_rng(1000 + cls)
    yy, xx = np.mgrid[0:size, 0:size]
    theta = cls * np.pi / NUM_CLASSES
    freq = 0.5 + 0.35 * (cls % 5)
    wave = np.sin(freq * (np.cos(theta) * xx + np.sin(theta) * yy))
    base = rng.integers(40, 216, size=3)
    tex = np.stack([(base[c] + 70 * wave) for c in range(3)], axis=-1)
    tex += rng.normal(0, 6, tex.shape)
    return np.clip(tex, 0, 255).astype(np.uint8)


_TEXTURES = [_class_texture(c) for c in range(NUM_CLASSES)]


@dataclasses.dataclass
class CameraSpec:
    cam_id: int
    class_mix: np.ndarray            # (NUM_CLASSES,) arrival probabilities
    busy_period_s: float = 120.0     # periodicity of busy times (paper §III-A)
    busy_phase: float = 0.0
    base_rate: float = 0.8           # objects per sampled frame, off-peak
    busy_boost: float = 3.0
    height: int = 96
    width: int = 128

    def rate_at(self, t_s: float) -> float:
        phase = 2 * np.pi * (t_s / self.busy_period_s) + self.busy_phase
        return self.base_rate * (1.0 + self.busy_boost *
                                 max(0.0, np.sin(phase)) ** 2)


def make_cameras(n: int, seed: int = 0,
                 contexts: int = 2) -> List[CameraSpec]:
    """n cameras split across `contexts` scene types (road-like vs
    plaza-like), with per-camera jitter — clusterable by K-means."""
    rng = np.random.default_rng(seed)
    cams = []
    for i in range(n):
        ctx = i % contexts
        mix = np.full(NUM_CLASSES, 0.02)
        if ctx == 0:                          # road: vehicles dominate
            mix[[1, 3, 4, 6, 9]] += [0.30, 0.16, 0.08, 0.10, 0.08]
        else:                                 # plaza: people dominate
            mix[[2, 5, 7, 10]] += [0.38, 0.12, 0.10, 0.12]
        mix += rng.uniform(0, 0.03, NUM_CLASSES)
        mix /= mix.sum()
        cams.append(CameraSpec(
            cam_id=i, class_mix=mix,
            busy_period_s=rng.uniform(90, 180),
            busy_phase=rng.uniform(0, 2 * np.pi),
            base_rate=rng.uniform(0.5, 1.2)))
    return cams


@dataclasses.dataclass
class FrameTruth:
    classes: List[int]
    boxes: List[Tuple[int, int]]             # top-left corners


def _background(cam: CameraSpec) -> np.ndarray:
    rng = np.random.default_rng(500 + cam.cam_id)
    H, W = cam.height, cam.width
    yy, xx = np.mgrid[0:H, 0:W]
    bg = 90 + 40 * np.sin(xx / rng.uniform(15, 40)) \
        + 30 * np.cos(yy / rng.uniform(10, 30))
    bg = np.stack([bg + rng.uniform(-20, 20) for _ in range(3)], axis=-1)
    return np.clip(bg, 0, 255).astype(np.uint8)


def render_triple(cam: CameraSpec, t_s: float, rng: np.random.Generator
                  ) -> Tuple[np.ndarray, FrameTruth]:
    """Three consecutive frames (for frame differencing) + middle-frame truth.

    Objects move ~3 px/frame; sensor noise ~N(0, 2).
    """
    H, W = cam.height, cam.width
    bg = _background(cam)
    n_obj = rng.poisson(cam.rate_at(t_s))
    classes, boxes = [], []
    frames = np.stack([bg.copy() for _ in range(3)]).astype(np.int32)
    for _ in range(int(n_obj)):
        cls = int(rng.choice(NUM_CLASSES, p=cam.class_mix))
        y = int(rng.integers(0, H - SPRITE))
        x = int(rng.integers(4, W - SPRITE - 4))
        vy, vx = int(rng.integers(-2, 3)), int(rng.integers(2, 5))
        tex = _TEXTURES[cls]
        for fi, dt in enumerate((-1, 0, 1)):
            yy = np.clip(y + vy * dt * 3, 0, H - SPRITE)
            xx = np.clip(x + vx * dt * 3, 0, W - SPRITE)
            frames[fi, yy:yy + SPRITE, xx:xx + SPRITE] = tex
        classes.append(cls)
        boxes.append((y, x))
    frames = frames + rng.normal(0, 2.0, frames.shape)
    frames = np.clip(frames, 0, 255).astype(np.uint8)
    return frames, FrameTruth(classes, boxes)


def object_crop(cls: int, rng: np.random.Generator, size: int = 32
                ) -> np.ndarray:
    """A labeled 'detected object' image (training data for CQ models)."""
    canvas = rng.integers(60, 180, (size, size, 3)).astype(np.float64)
    tex = _TEXTURES[cls].astype(np.float64)
    off = (size - SPRITE) // 2 + rng.integers(-4, 5)
    off = int(np.clip(off, 0, size - SPRITE))
    canvas[off:off + SPRITE, off:off + SPRITE] = tex
    canvas += rng.normal(0, 8, canvas.shape)
    return np.clip(canvas, 0, 255).astype(np.uint8)


# --- crop -> token sequence for the transformer classifiers -------------------

_PATCH = 8


def crops_to_tokens(crops: np.ndarray, vocab_size: int,
                    seed: int = 7) -> np.ndarray:
    """(N, S, S, 3) uint8 -> (N, T) int32 patch tokens.

    Patches are quantized with a fixed random projection + sign hash (an
    LSH codebook): deterministic, collision-sparse, and learnable.
    """
    N, S, _, _ = crops.shape
    t = S // _PATCH
    x = crops.reshape(N, t, _PATCH, t, _PATCH, 3).transpose(0, 1, 3, 2, 4, 5)
    x = x.reshape(N, t * t, _PATCH * _PATCH * 3).astype(np.float64)
    x = (x - x.mean(-1, keepdims=True)) / (x.std(-1, keepdims=True) + 1e-6)
    rng = np.random.default_rng(seed)
    nbits = max(int(np.floor(np.log2(max(vocab_size - 1, 2)))), 1)
    proj = rng.normal(size=(_PATCH * _PATCH * 3, nbits))
    bits = (x @ proj) > 0
    tokens = bits @ (1 << np.arange(nbits))
    return np.minimum(tokens, vocab_size - 1).astype(np.int32)


def labeled_crop_batch(classes: Sequence[int], rng: np.random.Generator,
                       vocab_size: int, size: int = 32
                       ) -> Tuple[np.ndarray, np.ndarray]:
    crops = np.stack([object_crop(c, rng, size) for c in classes])
    return crops_to_tokens(crops, vocab_size), np.asarray(classes, np.int32)


def crop_embedding(crop: np.ndarray, dim: int) -> np.ndarray:
    """Cheap appearance embedding for one detection crop: 4x4 average-
    pooled RGB, mean-centered, L2-normalized, truncated/zero-padded to
    ``dim``.  Deterministic in the pixels, so the pixel frontend's re-ID
    embeddings are reproducible without a model in the loop; crops of the
    same class texture land close in cosine, different textures far."""
    S = crop.shape[0]
    p = crop.reshape(4, S // 4, 4, S // 4, 3).mean(axis=(1, 3)).reshape(-1)
    p = p - p.mean()
    v = np.zeros(dim, np.float32)
    n = min(dim, p.size)
    v[:n] = p[:n]
    nrm = float(np.linalg.norm(v))
    return v / nrm if nrm > 0 else v
