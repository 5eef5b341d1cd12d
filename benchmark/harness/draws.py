"""The benchmark's random draws, made from ``--seed``.

The program under test draws its batch choices and augmentation from a
numpy ``Generator`` that its caller supplies (``make_rng``), and its head
dropout keeps from a callable (``dropout_keep_fn``). The benchmark hands it
generators seeded from ``(seed, call)``, and the reference replays the
same streams in the documented order of the draws: per epoch the
class-balanced ``choice`` pairs of every batch, then per batch (per TTA
pass in predict) the angle, translation, intensity scale and shift and the
noise over ``[B, L, h, w]``.
"""
import numpy as np

KEEP_STREAM = 1


def generator(seed: int, *key: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence(
        [int(seed) % 2**64, *key])))


class CallRngs:
    """``make_rng`` for the program: call ``k`` gets ``generator(seed, k)``."""

    def __init__(self, seed: int):
        self.seed, self.calls = seed, 0

    def __call__(self) -> np.random.Generator:
        g = generator(self.seed, self.calls)
        self.calls += 1
        return g


def keep_fn(seed: int, call: int, dropout: float):
    """``dropout_keep_fn`` of one training call: bool [B, L, H] keeps."""
    g = generator(seed, call, KEEP_STREAM)
    return lambda B, L, H: g.random((B, L, H)) < (1.0 - dropout)


def aug(rng: np.random.Generator, B: int, L: int, h: int, w: int, p: dict) -> dict:
    """One batch's augmentation draws, float32, in the program's order."""
    angle = rng.uniform(-p["max_rotation_deg"], p["max_rotation_deg"], size=B)
    translate = rng.uniform(-p["max_translation"], p["max_translation"], size=(B, 2))
    translate = translate * np.array([h, w])
    scale = 1.0 + rng.uniform(-p["intensity_scale"], p["intensity_scale"], size=B)
    shift = rng.uniform(-p["intensity_shift"], p["intensity_shift"], size=B)
    if p["noise_std"] > 0:
        noise = rng.normal(0.0, p["noise_std"], size=(B, L, h, w)).astype(np.float32)
    else:
        noise = np.zeros((B, L, h, w), np.float32)
    return {"angle": np.float32(angle), "translate": np.float32(translate),
            "scale": np.float32(scale), "shift": np.float32(shift), "noise": noise}


def balanced_batches(y: np.ndarray, rng: np.random.Generator, bs: int):
    """One epoch's class-balanced batches: half positives, half negatives,
    each batch drawn without replacement where the class allows."""
    pos, neg = np.where(y >= 0.5)[0], np.where(y < 0.5)[0]
    half = max(1, bs // 2)
    n_batches = max(1, int(np.ceil(len(y) / bs)))
    return [np.concatenate([rng.choice(pos, half, replace=len(pos) < half),
                            rng.choice(neg, bs - half, replace=len(neg) < bs - half)])
            for _ in range(n_batches)]
