"""Drive ``train_maxvit``: the ``train`` drive's calls on a MaxViT backbone.

Everything but the backbone is the ``train`` drive's: one
``MilAttentionFineTuneModel.train`` call after another on one model, the
set-up's call and the window's last checked over their first
``checked_steps`` steps, the same draws, head, numbers and limits'
meaning, the running statistics compared among the changes. The
backbone's table is the configuration's ``architecture`` block
(``reference/maxvit.py``'s ``arch_from``); its weights are made from the
seed as torchvision's ``maxvit_t`` init makes them (``backbone``) under
torchvision's state_dict names, which the program's
``nn/maxvit.py::torchvision_names`` maps onto its tree; the reference is
``reference/mil_ft_maxvit.py``. A program without ``nn/maxvit.py`` cannot
run the cell: the drive raises as it is built.
"""
import importlib
import math
from typing import Dict

import numpy as np
import torch

from benchmark import flops_maxvit
from benchmark.drives.train import HEAD_NAMES, Train
from benchmark.harness import draws, weights
from benchmark.harness.drive import (BAGS_STREAM, WEIGHTS_STREAM, Drive, dev, host, precision,
                                     torch_generator)
from benchmark.reference import maxvit, mil_ft_maxvit

INIT_STD = 0.02


def backbone(a: maxvit.Arch, size: int, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """torchvision's init from the seed, in one large draw: convolutions',
    linears' weights and the bias tables normal with std 0.02 (the tables'
    ``trunc_normal_`` cuts at +-2, 100 std away: nothing), biases 0, BN and
    LN at identity, running means 0 and variances 1."""
    shapes = maxvit.param_shapes(a, size)
    normal = [k for k, s in shapes.items() if k.endswith("bias_table") or (
        k.endswith(".weight") and len(s) > 1)]
    sizes = [math.prod(shapes[k]) for k in normal]
    out = dict(zip(normal, (t.view(shapes[k]) for k, t in zip(normal, torch.split(
        torch.randn(sum(sizes), generator=gen, device=device) * INIT_STD, sizes)))))
    for k, shape in {**shapes, **maxvit.running_shapes(a, size)}.items():
        if k not in out:
            fill = torch.ones if k.endswith((".weight", "running_var")) else torch.zeros
            out[k] = fill(shape, device=device)
    return out


def _program():
    return importlib.import_module("pd_fusion_torch.nn.maxvit")


def to_program(named: Dict, arch) -> Dict:
    """Flat torchvision names -> the program's nested tree (an int in a path
    indexes a list), without copies."""
    tree: Dict = {}
    for name, path in _program().torchvision_names(arch).items():
        node = tree
        for part, nxt in zip(path[:-1], path[1:]):
            child = [] if isinstance(nxt, int) else {}
            if isinstance(node, list):
                node.extend([None] * (part + 1 - len(node)))
                node[part] = child if node[part] is None else node[part]
                node = node[part]
            else:
                node = node.setdefault(part, child)
        node[path[-1]] = named[name]
    return tree


def from_program(tree: Dict, arch) -> Dict:
    """The program's nested tree -> flat torchvision names."""
    out = {}
    for name, path in _program().torchvision_names(arch).items():
        node = tree
        for part in path:
            node = node[part]
        out[name] = node
    return out


class TrainMaxvit(Train):
    def __init__(self, cell, seed, device):
        Drive.__init__(self, cell, seed, device)
        self.mv = maxvit.arch_from(cell.config["architecture"])
        program = _program()  # raises on a program without MaxViT, before any work
        a = program.ARCHS[self.arch]
        if (a.stem, a.widths, a.depths, a.head_dim, a.partition, a.expansion, a.squeeze,
                a.mlp_ratio) != (self.mv.stem, self.mv.widths, self.mv.depths, self.mv.head_dim,
                                 self.mv.partition, self.mv.expansion, self.mv.squeeze,
                                 self.mv.mlp_ratio):
            raise ValueError(f"the program's {self.arch} is not the configuration's: {a}")
        self.steps_per_call = max(1, math.ceil(self.n_bags / self.bs))
        self.work_per_call = self.steps_per_call * self.bs * self.L  # slices
        self.flops_per_call = self.steps_per_call * flops_maxvit.train_step(
            self.mv, self.size, self.bs, self.L, self.H, self.A)
        self.n_checked = int(cell.mix["checked_steps"])
        self.dropout = float(self.p["dropout"])
        if not (self.p["train_aug"] and self.p["balanced_batches"]):
            raise ValueError("the reference replays augmented, class-balanced batches only")
        self.rec: Dict = {}

    def make_inputs(self):
        gen = torch_generator(self.seed, BAGS_STREAM, self.device)
        x = torch.rand(self.n_bags, self.L, self.h, self.w, generator=gen, device=self.device)
        self.bags = list(x.cpu().numpy())
        self.y = (np.arange(self.n_bags) < int(self.cell.mix["positive_bags"])).astype(np.float32)
        gen = torch_generator(self.seed, WEIGHTS_STREAM, self.device)
        bp = backbone(self.mv, self.size, gen, self.device)
        hp = weights.head(maxvit.emb_dim(self.mv), self.H, self.A, gen, self.device)
        return bp, hp

    def build_model(self, bp, hp):
        from pd_fusion_torch.models import mil_attention_finetune as mft

        self.mft = mft
        self.rngs = draws.CallRngs(self.seed)
        self.model = mft.MilAttentionFineTuneModel(dict(self.p), device=self.device,
                                                   make_rng=self.rngs)
        self.model.backbone_params = to_program(bp, self.arch)
        self.model.head_params = weights.to_program_head(hp)

    def _flat(self, backbone, head) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in {
            **from_program(backbone, self.arch), **weights.from_program_head(head)}.items()}

    def _observe(self):
        """Wrap the program's ``ft_step`` as ``train``'s drive does, with the
        leaves' order of the program's MaxViT tree."""
        mft, n = self.mft, self.n_checked
        self._step = step = mft.ft_step
        names = _program().torchvision_names(self.arch)
        self.order = (mft.trainable_leaves(to_program({k: k for k in names}, self.arch)),
                      mft.trainable_leaves(weights.to_program_head({k: k for k in HEAD_NAMES})))

        def observed(*args, **kwargs):
            out = step(*args, **kwargs)
            rec = self.rec
            if len(rec["loss"]) < n:
                rec["loss"].append(out[2])
                if len(rec["loss"]) == 1:
                    rec["mu"] = {g: [t.detach().clone() for t in s["mu"]]
                                 for g, s in self.model.opt_state.items()}
                if len(rec["loss"]) == n:
                    rec["after"] = self._flat(out[0], out[1])
            return out

        mft.ft_step = observed

    def reference(self, rec: Dict, tf32: bool = False, half: bool = False):
        bp, hp = dev(rec["start"][0], self.device), dev(rec["start"][1], self.device)
        with precision(tf32):
            steps = mil_ft_maxvit.train_steps(
                bp, hp, self.batches(rec["call"], self.n_checked, half), self.hy, self.mv)
        return [{"loss": float(s["loss"]), "grads": host(s["grads"]), "taken": host(s["taken"]),
                 "after": {**host(s["backbone"]), **host(s["head"])}} for s in steps]


DRIVE = TrainMaxvit
