"""What every drive shares: the cell's settings, the weights and bags made
from ``--seed``, the program's model object, and the timing of set-up.

A mix (``mixes/<traffic>.json``) names its drive (``drive``), the one
general generator of its traffic, found by name at ``drives/<drive>.py``
(its ``DRIVE``), and its parameters: how many bags a call takes and how
many are positive, the configuration settings it overrides for its calls,
and how much of the timed path the check follows. A drive is a class of
its own, built as ``DRIVE(cell, seed, device)``, with

- ``rate``: the end-to-end metric it reports, ``work_per_call`` (that
  metric's units a call) and ``flops_per_call`` (model FLOPs a call);
- ``setup()``: everything before the window, the warm-up included;
- ``call()``: one call of the timed path; the window repeats it;
- ``attempted(calls)`` and ``failed()``: the contract's counts;
- ``release()``: frees the program's state once the window has closed;
- ``check()``: the numbers compared with the reference (``limits/``);
- ``calibrate(control)``: the readings that the limits are set from
  (``calibrate.py``; never in the benchmark's own runs).

Bags are float32 ``[slice_count, h, w]`` arrays in [0, 1], weights and
every draw are made from ``--seed`` (``harness/draws.py``,
``harness/weights.py``).
"""
import contextlib
import gc
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import draws, weights
from benchmark.reference import mil_ft, resnet

BAGS_STREAM, WEIGHTS_STREAM, SAMPLE_STREAM = 1, 2, 3


def torch_generator(seed: int, stream: int, device) -> torch.Generator:
    s = np.random.SeedSequence([int(seed) % 2**64, 1 << 20, stream]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(s[0]) % 2**63)


@contextlib.contextmanager
def precision(tf32: bool):
    """The reference's float32 (TF32 off), or TF32 for the control."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def host(tree: Dict) -> Dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def dev(tree: Dict, device) -> Dict:
    return {k: v.to(device) for k, v in tree.items()}


class Drive:
    """Settings, weights, bags and the model object of one run."""

    rate = ""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, int(seed), torch.device(device)
        self.p = {**cell.config["params"], **cell.mix.get("params", {})}
        self.arch = self.p["backbone"]
        self.bs, self.L = int(self.p["batch_size"]), int(self.p["slice_count"])
        self.h, self.w = (int(v) for v in self.p["target_shape"][:2])
        self.size = int(self.p["input_size"])
        self.H, self.A = int(self.p["hidden_dim"]), int(self.p["attn_dim"])
        self.n_bags = int(cell.mix["bags"])
        self.hy = mil_ft.hyper(self.p)
        self.model = None
        self.phases: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time a part of the set-up (synchronized), for the run's log."""
        t = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.phases[name] = time.perf_counter() - t

    def make_inputs(self):
        gen = torch_generator(self.seed, BAGS_STREAM, self.device)
        x = torch.rand(self.n_bags, self.L, self.h, self.w, generator=gen, device=self.device)
        self.bags: List[np.ndarray] = list(x.cpu().numpy())
        self.y = (np.arange(self.n_bags) < int(self.cell.mix["positive_bags"])).astype(np.float32)
        gen = torch_generator(self.seed, WEIGHTS_STREAM, self.device)
        bp = weights.backbone(self.arch, gen, self.device)
        hp = weights.head(resnet.emb_dim(self.arch), self.H, self.A, gen, self.device)
        return bp, hp

    def build_model(self, bp, hp):
        from pd_fusion_torch.models import mil_attention_finetune as mft

        self.mft = mft
        self.rngs = draws.CallRngs(self.seed)
        self.model = mft.MilAttentionFineTuneModel(dict(self.p), device=self.device,
                                                   make_rng=self.rngs)
        self.model.backbone_params = weights.to_program_backbone(bp, self.arch)
        self.model.head_params = weights.to_program_head(hp)

    def release(self):
        """Free the program's state before the reference runs."""
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def attempted(self, calls: int) -> int:
        return calls * self.n_bags

    def failed(self) -> int:
        return 0

    def aug(self, rng, B):
        d = draws.aug(rng, B, self.L, self.h, self.w, self.p)
        return {k: torch.as_tensor(v, device=self.device) for k, v in d.items()}
