"""Drive ``embed``: one slice-embedding build after another,
``imaging/pipeline.py::run_resnet_embedding_pipeline`` over NIfTI paths
(host prep on the prefetch threads, pinned staging, the BN-folded ResNet,
mean-pooled), as ``scripts/build_resnet2d_embeddings`` runs it.

Set-up writes ``volumes`` seeded int16 volumes of ``volume_shape`` as
gzipped NIfTI-1 files into a fresh directory under ``TMPDIR`` (so the
files, and the page cache's share of reading them, are alike in every
run), and a build takes them cycled to ``bags`` paths. The backbone is
the benchmark's ResNet (``harness/weights.py``) with its running
statistics set from one batch: the reference's prep of volume 0, as a
settled network's. Every build's embeddings are kept; after the window a
sample of its builds, drawn from the seed, is checked against the
reference (``reference/embed.py``), which redoes each volume from its
file. ``emb_gap``: the largest gap of a path's embedding over the
reference's norm.
"""
import atexit
import gzip
import math
import shutil
import struct
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops
from benchmark.harness import draws, weights
from benchmark.harness.drive import (SAMPLE_STREAM, WEIGHTS_STREAM, Drive, dev, host, precision,
                                     torch_generator)
from benchmark.reference import embed, mil_ft

VOLUME_STREAM = 4


def write_nifti(path: Path, vol: np.ndarray, level: int):
    """A single-file NIfTI-1 of int16 ``vol`` (Fortran order), gzipped."""
    header = bytearray(348)
    struct.pack_into("<i", header, 0, 348)
    struct.pack_into("<8h", header, 40, 3, *vol.shape, 1, 1, 1, 1)
    struct.pack_into("<2h", header, 70, 4, 16)  # int16, 16 bits
    struct.pack_into("<9f", header, 76, *([1.0] * 8), 352.0)  # pixdim, vox_offset
    struct.pack_into("<2f", header, 112, 1.0, 0.0)  # scl_slope, scl_inter
    header[344:348] = b"n+1\x00"
    with gzip.open(path, "wb", compresslevel=level) as f:
        f.write(bytes(header) + b"\x00" * 4 + vol.astype("<i2").tobytes(order="F"))


class Embed(Drive):
    rate = "infer_slices_per_s"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.mixp = cell.mix
        self.count = int(self.p["slice_count"])
        self.target = [int(t) for t in self.p["target_shape"]]
        self.axis = int(self.p.get("slice_axis", 2))
        self.work_per_call = self.n_bags * self.count  # slices
        self.flops_per_call = self.work_per_call * flops.backbone_forward(self.arch,
                                                                          self.size)[0]
        self.outputs: List[np.ndarray] = []
        self.dir = None

    def _volumes(self):
        """The seeded volumes, written in parallel (zlib frees the GIL)."""
        shape = tuple(int(s) for s in self.mixp["volume_shape"])
        self.dir = Path(tempfile.mkdtemp(prefix="embed_build_"))
        atexit.register(shutil.rmtree, self.dir, True)
        rng = draws.generator(self.seed, VOLUME_STREAM)
        box = tuple(slice(int(a), int(b)) for a, b in self.mixp["foreground"])
        vols = []
        for _ in range(int(self.mixp["volumes"])):
            v = rng.random(shape, dtype=np.float32) * 0.3
            v[box] += 0.5
            vols.append((v * 1000.0).astype(np.int16))
        self.files = [self.dir / f"sub-{i:02d}_T1w.nii.gz" for i in range(len(vols))]
        with ThreadPoolExecutor(max_workers=4) as pool:
            list(pool.map(lambda fv: write_nifti(fv[0], fv[1], int(self.mixp["gzip_level"])),
                          zip(self.files, vols)))
        self.paths = [str(self.files[i % len(self.files)]) for i in range(self.n_bags)]
        self.ids = [f"s{i}" for i in range(self.n_bags)]

    def setup(self):
        with self.phase("volumes"):
            self._volumes()
        with self.phase("inputs"):
            gen = torch_generator(self.seed, WEIGHTS_STREAM, self.device)
            bp = weights.backbone(self.arch, gen, self.device)
            self.mean = torch.tensor(self.hy["mean"], device=self.device)
            self.std = torch.tensor(self.hy["std"], device=self.device)
            x = embed.prep(self.files[0], self.target, self.axis, self.count, self.device)
            bp = mil_ft.bn_stats_from_batch(bp, mil_ft.imagenet_batch(x, self.size, self.mean,
                                                                      self.std), self.arch)
            self.init = host(bp)
            self.program_params = weights.to_program_backbone(bp, self.arch)
        with self.phase("first call"):
            from pd_fusion_torch.imaging import pipeline

            self.pipeline = pipeline
            self.call()

    def call(self):
        out = self.pipeline.run_resnet_embedding_pipeline(
            self.paths, self.ids, self.program_params, self.hy["mean"], self.hy["std"],
            arch=self.arch, target_shape=tuple(self.target), axes=[self.axis],
            counts=[self.count], input_size=self.size, tta=1, per_slice=False, progress=False,
            device=self.device)
        self.outputs.append(np.stack(out).astype(np.float32))

    def release(self):
        self.program_params = None
        super().release()

    def failed(self) -> int:
        """Embeddings of the window's builds that are not finite."""
        return int(sum((~np.isfinite(a)).sum() for a in self.outputs[1:]))

    def sample(self) -> List[int]:
        """The window's builds to check, drawn from the seed."""
        n = len(self.outputs) - 1
        k = min(int(self.mixp["sampled_calls"]), n)
        rng = draws.generator(self.seed, SAMPLE_STREAM)
        return sorted(int(i) + 1 for i in rng.choice(n, k, replace=False))

    def reference(self, tf32: bool = False, half: bool = False) -> np.ndarray:
        """The reference's embedding of every volume [volumes, emb]
        (``half``: the fault that pools half of each volume's slices)."""
        bp = dev(self.init, self.device)
        with precision(tf32):
            return np.stack([embed.embed(bp, embed.prep(f, self.target, self.axis, self.count,
                                                        self.device), self.arch, self.size,
                                         self.mean, self.std,
                                         self.count // 2 if half else None).cpu().numpy()
                             for f in self.files])

    def numbers(self, observed: Dict[int, np.ndarray], ref: np.ndarray) -> Dict[str, float]:
        gap = 0.0 if observed else math.inf
        want = ref[np.arange(self.n_bags) % len(ref)].astype(np.float64)
        norms = np.linalg.norm(want, axis=1)
        for p in observed.values():
            if p.shape != want.shape or not np.isfinite(p).all():
                return {"emb_gap": math.inf}
            gap = max(gap, float(np.max(np.linalg.norm(p - want, axis=1) / norms)))
        return {"emb_gap": gap}

    def check(self) -> Dict[str, float]:
        observed = {k: self.outputs[k] for k in self.sample()}
        out = self.numbers(observed, self.reference())
        shutil.rmtree(self.dir, ignore_errors=True)
        return out

    def calibrate(self, control: bool) -> Dict[str, Dict]:
        """After ``setup()``: as many builds as a run compares, then their
        readings; on a control seed also the control (TF32) and the fault
        (half of each volume's slices pooled) in the program's place."""
        for _ in range(int(self.mixp["sampled_calls"])):
            self.call()
        self.release()
        calls = self.sample()
        ref = self.reference()
        out = {"program": dict(self.numbers({k: self.outputs[k] for k in calls}, ref),
                               calls=calls)}
        if control:
            rows = np.arange(self.n_bags) % len(ref)
            out["control_tf32"] = self.numbers({0: self.reference(tf32=True)[rows]}, ref)
            out["fault_half_slices"] = self.numbers({0: self.reference(half=True)[rows]}, ref)
        shutil.rmtree(self.dir, ignore_errors=True)
        return out


DRIVE = Embed
