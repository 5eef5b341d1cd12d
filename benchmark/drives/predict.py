"""Drive ``predict``: ``MilAttentionFineTuneModel.predict_proba(bags)``,
one call after another on one model object, with the mix's TTA passes.
Every call's answers are kept; after the window a sample of its calls,
drawn from the seed, is predicted again by the reference from the same
weights and draws. The batch norms' running statistics are one batch's
statistics of ``bn_stats_slices`` unaugmented slices, as a settled
network's.
"""
import math
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops
from benchmark.harness import draws
from benchmark.harness.drive import SAMPLE_STREAM, Drive, dev, host, precision
from benchmark.reference import mil_ft


class Predict(Drive):
    rate = "infer_slices_per_s"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.tta = int(self.p["tta_inference"])
        self.work_per_call = self.n_bags * self.L * self.tta  # slice passes
        chunks = [min(self.bs, self.n_bags - s) for s in range(0, self.n_bags, self.bs)]
        self.flops_per_call = self.tta * sum(
            flops.predict_pass(self.arch, self.size, b, self.L, self.H, self.A) for b in chunks)
        self.outputs: List[np.ndarray] = []

    def setup(self):
        with self.phase("inputs"):
            bp, hp = self.make_inputs()
            n = int(self.cell.mix["bn_stats_slices"])
            x = torch.as_tensor(self.bags[0][:n], device=self.device)
            mean = torch.tensor(self.hy["mean"], device=self.device)
            std = torch.tensor(self.hy["std"], device=self.device)
            bp = mil_ft.bn_stats_from_batch(bp, mil_ft.imagenet_batch(x, self.size, mean, std),
                                            self.arch)
            self.init = (host(bp), host(hp))
        with self.phase("model"):
            self.build_model(bp, hp)
            del bp, hp
        with self.phase("first call"):
            self.call()

    def call(self):
        self.outputs.append(np.asarray(self.model.predict_proba(self.bags), np.float32))

    def failed(self) -> int:
        """Answers of the window's calls that are not finite."""
        return int(sum((~np.isfinite(a)).sum() for a in self.outputs[1:]))

    def sample(self) -> List[int]:
        """The window's calls to check, drawn from the seed."""
        n = len(self.outputs) - 1
        k = min(int(self.cell.mix["sampled_calls"]), n)
        rng = draws.generator(self.seed, SAMPLE_STREAM)
        return sorted(int(i) + 1 for i in rng.choice(n, k, replace=False))

    def reference(self, calls, tf32: bool = False, half: bool = False):
        bp, hp = dev(self.init[0], self.device), dev(self.init[1], self.device)
        bags = [torch.as_tensor(b, device=self.device) for b in self.bags]
        out = {}
        with precision(tf32):
            for k in calls:
                rng = draws.generator(self.seed, k)
                out[k] = mil_ft.predict(bp, hp, bags, lambda B, L, h, w: self.aug(rng, B),
                                        self.hy, self.bs, self.tta,
                                        self.L // 2 if half else None)
        return out

    def numbers(self, observed: Dict[int, np.ndarray], ref: Dict[int, np.ndarray]):
        gap = 0.0 if ref else math.inf
        for k, r in ref.items():
            p = observed.get(k)
            if p is None or p.shape != r.shape or not np.isfinite(p).all():
                return {"prob_gap": math.inf}
            gap = max(gap, float(np.max(np.abs(p.astype(np.float64) - r))))
        return {"prob_gap": gap}

    def check(self) -> Dict[str, float]:
        calls = self.sample()
        observed = {k: self.outputs[k] for k in calls}
        return self.numbers(observed, self.reference(calls))

    def calibrate(self, control: bool) -> Dict[str, Dict]:
        """After ``setup()``: as many calls as a run compares, at the cell's
        own load, then their readings; on a control seed also the control
        (TF32) and the fault (half of each bag left out) in the program's
        place."""
        for _ in range(int(self.cell.mix["sampled_calls"])):
            self.call()
        self.release()
        calls = self.sample()
        ref = self.reference(calls)
        out = {"program": dict(self.numbers({k: self.outputs[k] for k in calls}, ref),
                               calls=calls)}
        if control:
            out["control_tf32"] = self.numbers(self.reference(calls, tf32=True), ref)
            out["fault_half_bag"] = self.numbers(self.reference(calls, half=True), ref)
        return out


DRIVE = Predict
