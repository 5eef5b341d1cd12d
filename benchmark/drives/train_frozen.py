"""Drive ``train_frozen``: the ``train`` drive's calls with the backbone
frozen on every step (the mix sets ``freeze_backbone_epochs`` to cover
every epoch of a call: gate 0). The reference follows the frozen step
(``reference/mil_ft_frozen.py``): the backbone's train-mode forward without
gradient, its running statistics moved, the head alone clipped and
stepped, the backbone's weights left as they were.

What it compares differs from ``train``'s where the gate shows: the
gradient Adam took is compared over the head's leaves (the backbone takes
none), and a leaf's change after three steps over the leaves that the
reference moves (the running statistics and the head), with the
backbone's weights, which must not move, read against the same median
leaf's change: any move of them is a gap of its own size.
"""
import math
import statistics
from typing import Dict

from benchmark import flops
from benchmark.drives.train import Train
from benchmark.harness import compare
from benchmark.harness.drive import dev, host, precision
from benchmark.reference import mil_ft_frozen, resnet


class TrainFrozen(Train):
    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        if int(self.p["freeze_backbone_epochs"]) < int(self.p["epochs"]):
            raise ValueError("the frozen reference follows calls whose every epoch is frozen")
        f, _ = flops.backbone_forward(self.arch, self.size)
        self.flops_per_call = self.steps_per_call * (
            self.bs * self.L * f
            + 3 * self.bs * flops.head_forward(resnet.emb_dim(self.arch), self.H, self.A, self.L))
        self.weight_names = resnet.trainable(self.arch)

    def reference(self, rec: Dict, tf32: bool = False, half: bool = False):
        bp, hp = dev(rec["start"][0], self.device), dev(rec["start"][1], self.device)
        with precision(tf32):
            steps = mil_ft_frozen.train_steps(
                bp, hp, self.batches(rec["call"], self.n_checked, half), self.hy)
        return [{"loss": float(s["loss"]), "grads": host(s["grads"]), "taken": host(s["taken"]),
                 "after": {**host(s["backbone"]), **host(s["head"])}} for s in steps]

    def numbers(self, observed: Dict, ref) -> Dict[str, float]:
        moving = [dict(r, after={k: v for k, v in r["after"].items()
                                 if k not in self.weight_names}) for r in ref]
        out = super().numbers(observed, moving)
        init = {**observed["start"][0], **observed["start"][1]}
        keys = [k for k in moving[-1]["after"] if k not in self.unmoved]
        med = statistics.median(compare.norms(
            {k: moving[-1]["after"][k] - init[k] for k in keys}).values())
        after = observed["after"]
        still = compare.norms({k: after[k] - init[k] for k in self.weight_names if k in after})
        worst = max(still.values(), default=0.0) / med if med > 0 else math.inf
        if len(still) < len(self.weight_names) or not math.isfinite(worst):
            worst = math.inf
        if worst > out["change_gap"]:
            out["change_gap"], self.worst_change = worst, max(still, key=still.get)
        return out


DRIVE = TrainFrozen
