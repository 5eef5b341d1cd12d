"""Drive ``train``: ``MilAttentionFineTuneModel.train(bags, y,
dropout_keep_fn=...)``, one call after another on one model object; each
call is the mix's epochs, and the program starts Adam's state again at
each call.

The check follows two calls: the set-up's call, from the benchmark's own
weights, and the window's last call, from the parameters the program had
when that call began. Of each, the first ``checked_steps`` steps are
observed (the program's ``ft_step`` is wrapped while the drive lives: each
step's loss, Adam's first moment after the first, the parameters after
the last, and the parameters at the call's start), and the reference
follows them from the same start with the same draws. Each number
compared is the worse of the two calls'.
"""
import math
import sys
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops
from benchmark.harness import compare, draws, weights
from benchmark.harness.drive import Drive, dev, host, precision
from benchmark.reference import mil_ft, resnet

MOVED_SHARE = 1e-3  # a leaf whose gradient is under this share of the median leaf's is unmoved
HEAD_NAMES = [f"{n}.{k}" for n in mil_ft.HEAD_LINEARS for k in ("w", "b")]


class Train(Drive):
    rate = "train_slices_per_s"

    def __init__(self, cell, seed, device):
        super().__init__(cell, seed, device)
        self.steps_per_call = max(1, math.ceil(self.n_bags / self.bs))
        self.work_per_call = self.steps_per_call * self.bs * self.L  # slices
        self.flops_per_call = self.steps_per_call * flops.train_step(
            self.arch, self.size, self.bs, self.L, self.H, self.A)
        self.n_checked = int(cell.mix["checked_steps"])
        self.dropout = float(self.p["dropout"])
        if not (self.p["train_aug"] and self.p["balanced_batches"]):
            raise ValueError("the reference replays augmented, class-balanced batches only")
        self.rec: Dict = {}

    def setup(self):
        with self.phase("inputs"):
            bp, hp = self.make_inputs()
        with self.phase("model"):
            self.build_model(bp, hp)
            del bp, hp
            self._observe()
        with self.phase("first call"):
            self.call()
            self.first = self._settled(self.rec)

    def call(self):
        k = self.rngs.calls
        self.rec = {"call": k, "start": self._flat(self.model.backbone_params,
                                                   self.model.head_params), "loss": []}
        self.model.train(self.bags, self.y,
                         dropout_keep_fn=draws.keep_fn(self.seed, k, self.dropout))

    def attempted(self, calls: int) -> int:
        return calls * self.steps_per_call

    def release(self):
        self.last = self._settled(self.rec)
        self.mft.ft_step = self._step
        super().release()

    def _flat(self, backbone, head) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in {
            **weights.from_program_backbone(backbone, self.arch),
            **weights.from_program_head(head)}.items()}

    def _observe(self):
        """Wrap the program's ``ft_step``: of the current call, keep each of
        the first ``n_checked`` steps' loss, Adam's first moment after the
        first step and the parameters after the last (device copies)."""
        mft, n = self.mft, self.n_checked
        self._step = step = mft.ft_step
        names_b = resnet.trainable(self.arch) + resnet.running(self.arch)
        self.order = (mft.trainable_leaves(weights.to_program_backbone(
            {k: k for k in names_b}, self.arch)), mft.trainable_leaves(
            weights.to_program_head({k: k for k in HEAD_NAMES})))

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

    def _settled(self, rec: Dict) -> Dict:
        """A call's record on the host: the gradient Adam took (its first
        moment after one step over ``1 - beta1``) under the leaves' names."""
        if len(rec["loss"]) < self.n_checked:
            raise RuntimeError(f"call {rec['call']} took {len(rec['loss'])} steps, "
                               f"under {self.n_checked}")
        taken = {}
        for group, order in zip(("backbone", "head"), self.order):
            for name, mu in zip(order, rec["mu"][group]):
                taken[name] = mu.cpu() / (1.0 - mil_ft.BETA1)
        start = host(rec["start"])
        return {"call": rec["call"], "loss": [float(v) for v in rec["loss"]], "taken": taken,
                "after": host(rec["after"]),
                "start": ({k: v for k, v in start.items() if k not in HEAD_NAMES},
                          {k: v for k, v in start.items() if k in HEAD_NAMES})}

    def batches(self, call: int, n: int, half: bool = False) -> List[Dict]:
        """The reference's inputs for the first ``n`` steps of call
        ``call``, from the same draws the program took. ``half``: the
        fault that leaves out half of each batch's bags."""
        rng = draws.generator(self.seed, call)
        idx = draws.balanced_batches(self.y, rng, self.bs)
        keep = draws.keep_fn(self.seed, call, self.dropout)
        out = []
        for b in idx[:n]:
            if len(b) != self.bs:
                raise ValueError("the reference takes full batches only")
            d = self.aug(rng, self.bs)
            valid = torch.ones(self.bs, device=self.device)
            if half:
                valid[self.bs // 2:] = 0.0
            out.append(dict(d, slices=torch.as_tensor(np.stack([self.bags[j] for j in b]),
                                                      device=self.device),
                            mask=torch.ones(self.bs, self.L, device=self.device),
                            y=torch.as_tensor(self.y[b], device=self.device), valid=valid,
                            keep=torch.as_tensor(keep(self.bs, self.L, self.H),
                                                 device=self.device)))
        return out

    def reference(self, rec: Dict, tf32: bool = False, half: bool = False):
        """The reference's first ``n_checked`` steps of ``rec``'s call, from
        that call's start."""
        bp, hp = dev(rec["start"][0], self.device), dev(rec["start"][1], self.device)
        with precision(tf32):
            steps = mil_ft.train_steps(bp, hp, self.batches(rec["call"], self.n_checked, half),
                                       self.hy)
        return [{"loss": float(s["loss"]), "grads": host(s["grads"]), "taken": host(s["taken"]),
                 "after": {**host(s["backbone"]), **host(s["head"])}} for s in steps]

    @staticmethod
    def as_observed(steps, rec: Dict) -> Dict:
        """A reference run in the program's place (the control, a fault)."""
        return {"call": rec["call"], "start": rec["start"], "loss": [s["loss"] for s in steps],
                "taken": steps[0]["taken"], "after": steps[-1]["after"]}

    def numbers(self, observed: Dict, ref) -> Dict[str, float]:
        gaps = [compare.relative(p, r["loss"]) for p, r in zip(observed["loss"], ref)]
        gaps += [math.inf] * (len(ref) - len(gaps))
        self.loss_gaps = gaps
        grad_gap, self.worst_grad = compare.worst_leaf(compare.norms(observed["taken"]),
                                                        compare.norms(ref[0]["taken"]))
        raw = compare.norms(ref[0]["grads"])
        floor = MOVED_SHARE * float(np.median(list(raw.values())))
        init = {**observed["start"][0], **observed["start"][1]}
        keys = [k for k in ref[-1]["after"] if raw.get(k, math.inf) >= floor]
        self.unmoved = sorted(set(ref[-1]["after"]) - set(keys))
        change_p = compare.norms({k: observed["after"][k] - init[k] for k in keys
                                  if k in observed["after"]})
        change_r = compare.norms({k: ref[-1]["after"][k] - init[k] for k in keys})
        change_gap, self.worst_change = compare.worst_leaf(change_p, change_r, keys)
        return {"loss_gap": max(gaps), "first_loss_gap": gaps[0], "grad_gap": grad_gap,
                "change_gap": change_gap}

    def check(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for rec in (self.first, self.last):
            for k, v in self.numbers(rec, self.reference(rec)).items():
                out[k] = max(out.get(k, 0.0), v)
            print(f"call {rec['call']}: worst gradient leaf {self.worst_grad}, worst change "
                  f"leaf {self.worst_change}", file=sys.stderr)
        return out

    def calibrate(self, control: bool) -> Dict[str, Dict]:
        """After ``setup()``: one more call, then the readings of both
        calls. On a control seed also the reference again (its own
        rounding), the control (TF32) and the faults (half of each batch
        left out; a state left unchanged) in the program's place."""
        self.call()
        self.release()
        out = {}
        for tag, rec in (("first", self.first), ("window", self.last)):
            ref = self.reference(rec)
            out[f"program.{tag}"] = dict(self.numbers(rec, ref), worst_grad=self.worst_grad,
                                         worst_change=self.worst_change, unmoved=self.unmoved,
                                         loss_gaps=self.loss_gaps, call=rec["call"])
            if control:
                for side, kw in (("reference_again", {}), ("control_tf32", {"tf32": True}),
                                 ("fault_half_batch", {"half": True})):
                    run = self.as_observed(self.reference(rec, **kw), rec)
                    out[f"{side}.{tag}"] = self.numbers(run, ref)
                unchanged = dict(rec, taken={k: 0 * v for k, v in rec["taken"].items()},
                                 after={**rec["start"][0], **rec["start"][1]})
                out[f"fault_state_unchanged.{tag}"] = self.numbers(unchanged, ref)
        return out


DRIVE = Train
