"""Card-against-CPU checks of the embed path and its synthetic data, shared
by ``chip_smoke.py`` and the ``cuda``-marked tests (which import no JAX).

Tolerances, card against CPU on the same slices and weights:
- float32 with TF32 off (``utils/device.py``): max |card - cpu| at most
  ``F32_REL`` times max |cpu| (cuDNN and the CPU sum each convolution in
  other orders, some of its float32 algorithms through transforms, over
  up to 53 convolutions);
- bfloat16 (BN folded in float32, then cast): every embedding's cosine
  to the float32 CPU one at least ``BF16_COS``.
"""
import concurrent.futures as cf
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from pd_fusion_torch.imaging.nifti import write_nifti
from pd_fusion_torch.imaging.pipeline import _embed, fold_backbone
from pd_fusion_torch.nn.resnet import params_to

F32_REL = 2e-4
BF16_COS = 0.99


def _template(shape: Tuple[int, int, int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A brain-extracted T1w-like template: an ellipsoid brain (0 outside)
    with a bright white-matter core, grey-matter shell and dark ventricles,
    a smooth bias field, and the mask of a deep grey-matter region."""
    grids = np.ogrid[tuple(slice(0, s) for s in shape)]
    c = [s / 2.0 for s in shape]
    ax = [0.40 * shape[0], 0.40 * shape[1], 0.36 * shape[2]]
    r = sum(((g - ci) / ai) ** 2 for g, ci, ai in zip(grids, c, ax)).astype(np.float32)
    vol = np.where(r < 1.0, 420.0, 0.0).astype(np.float32)  # grey matter
    vol[r < 0.55] = 680.0  # white matter
    vent = sum(((g - ci) / (0.18 * ai)) ** 2 for g, ci, ai in zip(grids, c, ax)) < 1.0
    vol[vent] = 180.0  # ventricles (CSF)
    deep = sum(((g - ci - off) / (0.09 * ai)) ** 2
               for g, ci, ai, off in zip(grids, c, ax, (0.0, 0.12 * shape[1], 0.0))) < 1.0
    vol[deep] = 520.0  # a deep grey-matter nucleus
    bias = (1.0 + 0.08 * np.cos(grids[0] / shape[0] * np.pi) * np.sin(grids[1] / shape[1] * np.pi)
            ).astype(np.float32)
    return vol * bias, r < 1.0, deep


def synthetic_t1w_dataset(root: Path, n_subjects: int, shape=(176, 256, 256), slope=0.5,
                          seed=0, workers=8, compresslevel=1) -> Tuple[Path, List[Dict], float]:
    """Seeded synthetic T1w-like volumes, two sessions per subject, int16
    with ``scl_slope`` (session 1 ``.nii.gz`` at ``compresslevel``, session
    2 plain ``.nii``), and their manifest. Half the subjects are PD
    (label 1): their deep nucleus is 12% darker. -> (manifest, rows,
    seconds)."""
    t0 = time.perf_counter()
    root.mkdir(parents=True, exist_ok=True)
    template, brain, deep = _template(tuple(shape))
    rng = np.random.RandomState(seed)
    noise = (rng.standard_normal(shape).astype(np.float32) * 18.0) * brain
    labels = rng.permutation(np.repeat([0, 1], n_subjects - n_subjects // 2)[:n_subjects])
    jobs = []
    for s in range(n_subjects):
        for session in (1, 2):
            gain = np.float32(1.0 + 0.05 * rng.randn())
            shift = tuple(int(v) for v in rng.randint(0, 64, size=3))
            ext = ".nii.gz" if session == 1 else ".nii"
            jobs.append((root / f"sub-{s:03d}_ses-{session}_T1w{ext}", int(labels[s]), gain, shift))

    def write(job):
        path, label, gain, shift = job
        vol = template * gain + np.roll(noise, shift, axis=(0, 1, 2))
        if label:
            vol[deep] *= np.float32(0.88)
        write_nifti(path, np.round(vol / slope).astype(np.int16), scl_slope=slope,
                    compresslevel=compresslevel)

    with cf.ThreadPoolExecutor(workers) as pool:
        list(pool.map(write, jobs))
    rows = [{"subject_id": p.name.split("_")[0], "session": int(p.name.split("_")[1][-1]),
             "label": label, "t1wbrain_path": str(p)} for p, label, _, _ in jobs]
    manifest = root / "manifest.csv"
    lines = ["subject_id,session,label,t1wbrain_path"] + [
        f"{r['subject_id']},{r['session']},{r['label']},{r['t1wbrain_path']}" for r in rows]
    manifest.write_text("\n".join(lines) + "\n")
    return manifest, rows, time.perf_counter() - t0


def resnet_flops(folded, arch: str, size: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of the convolutions of one
    ``size``x``size`` image through ``resnet_apply_folded`` (elementwise
    work, pooling and the mean not counted)."""
    def conv(h, w, stride, pad):
        cout, cin, kh, kw = w.shape
        ho = (h + 2 * pad - kh) // stride + 1
        return ho, 2 * ho * ho * cout * cin * kh * kw

    h, total = conv(size, folded["conv1"]["w"], 2, 3)
    h = (h + 2 - 3) // 2 + 1  # max pool 3x3/s2, pad 1
    basic = arch == "resnet18"
    for li in range(4):
        for bi, p in enumerate(folded[f"layer{li + 1}"]):
            stride = 2 if (li > 0 and bi == 0) else 1
            names = ["conv1", "conv2"] if basic else ["conv1", "conv2", "conv3"]
            strides = [stride, 1] if basic else [1, stride, 1]
            h_in, hh = h, h
            for name, s in zip(names, strides):
                k = p[name]["w"].shape[2]
                hh, f = conv(hh, p[name]["w"], s, k // 2)
                total += f
            if "downsample" in p:
                total += conv(h_in, p["downsample"]["w"], stride, 0)[1]
            h = hh
    return total


def embed_on(params, slices: np.ndarray, arch: str, input_size: int, mean, std, device,
             compute_dtype: str = "float32") -> np.ndarray:
    """[N, h, w] slices -> [N, E] float32 embeddings on ``device``."""
    dev = torch.device(device)
    with torch.inference_mode():
        folded = fold_backbone(params_to(params, device=dev), arch, compute_dtype)
        x = torch.as_tensor(slices, dtype=torch.float32, device=dev)[None]
        m = torch.as_tensor(np.asarray(mean, np.float32), device=dev)
        s = torch.as_tensor(np.asarray(std, np.float32), device=dev)
        return _embed(folded, x, m, s, arch, input_size, per_slice=True)[0].cpu().numpy()


def compare_card_with_cpu(params, slices: np.ndarray, arch: str, input_size: int, mean, std,
                          device="cuda") -> Dict[str, float]:
    """The backbone on the card (float32, then bfloat16) against the CPU in
    float32 on the same slices; raises outside the stated bounds."""
    cpu = embed_on(params, slices, arch, input_size, mean, std, "cpu")
    card = embed_on(params, slices, arch, input_size, mean, std, device)
    scale = float(np.abs(cpu).max())
    err = float(np.abs(card - cpu).max())
    if not err <= F32_REL * scale:
        raise AssertionError(f"{arch} float32 card vs CPU: max abs err {err:.3e} > "
                             f"{F32_REL} x {scale:.3e}")
    bf16 = embed_on(params, slices, arch, input_size, mean, std, device, "bfloat16")
    cos = np.sum(bf16 * cpu, 1) / (np.linalg.norm(bf16, axis=1) * np.linalg.norm(cpu, axis=1))
    if not float(cos.min()) >= BF16_COS:
        raise AssertionError(f"{arch} bfloat16 card vs float32 CPU: min cosine {cos.min():.5f} "
                             f"< {BF16_COS}")
    return {"max_abs_err": err, "scale": scale, "rel_err": err / scale,
            "bf16_min_cos": float(cos.min()), "bf16_max_abs_err": float(np.abs(bf16 - cpu).max())}
