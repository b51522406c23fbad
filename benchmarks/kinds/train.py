"""Train steps: the train CLI's step on whole targets.

The system under test is models.train.make_train_step(make_optimizer(),
depth=12), the step trx2dy_torch.cli.train builds (batch 1, no dropout,
no remat, the logits attention), fed as the CLI's loop feeds it: the
example's MSA rows moved to the device, features made there with
get_f2d, labels and mask moved, the step, the loss read back.

Set-up builds one train state from weights drawn on the device from the
seed, prepares a pool of targets (synthetic MSAs and backbones, labels
by models.dataset.labels_from_structure) and drives the state through
its first `reference_steps` steps, on distinct targets, through the same
call; those steps are also the warm-up. It keeps their losses, each
parameter's first gradient as AdamW took it (its first moment over
1 - b1) and each parameter's change over those steps; the window then
goes on from that same state, cycling the pool. The check runs the
plain reference's steps from the same weights on the same targets and
compares the three.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import counts
from harness.core import Unit
from harness.synthetic import query_sequence, synthetic_backbone, \
    synthetic_msa
from harness.trace import label
from harness.weights import seeded_state, shapes_of, sub_seed

MEDIAN_SHARE = 1e-3   # leaves whose reference gradient is below this share
#                       of the median leaf's are round-off under AdamW


class Train:
    def __init__(self, ctx):
        from trx2dy_torch.device import resolve_device
        from trx2dy_torch.models.convert import load_into
        from trx2dy_torch.models.dataset import labels_from_structure
        from trx2dy_torch.models.predictor2d import DistPredictor
        from trx2dy_torch.models.train import (
            init_train_state, make_optimizer, make_train_step,
        )
        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.cfg, self.tr = ctx, cfg, tr
        self.device = resolve_device(str(ctx.device))
        with torch.device("meta"):
            shapes = shapes_of(DistPredictor(cfg["depth"], cfg["dim"],
                                             cfg["in_dim"]))
        self.state0 = seeded_state(shapes, sub_seed(ctx.seed, "weights"),
                                   self.device)
        with torch.device("meta"):
            model = DistPredictor(cfg["depth"], cfg["dim"], cfg["in_dim"])
        model = model.to_empty(device=self.device)
        load_into(model, self.state0)
        self.opt = make_optimizer(lr=tr["lr"])
        self.state = init_train_state(model, self.opt)
        self.step_fn = make_train_step(self.opt, depth=cfg["depth"])

        ctx.mark("weights")
        self.pool = []
        for t in range(tr["pool"]):
            rng = np.random.default_rng(sub_seed(ctx.seed, "target", t))
            msa = synthetic_msa(tr["length"], tr["msa_rows"], rng)
            coords = synthetic_backbone(tr["length"], rng)
            labels, mask = labels_from_structure(coords, query_sequence(msa))
            self.pool.append((msa, coords, labels, mask))
        ctx.mark("inputs")
        self.n = 0
        self.losses = []
        names = dict(self.state.model.named_parameters())
        for _ in range(tr["reference_steps"]):
            self.losses.append(self._step())
            if self.n == 1:
                ex = self.state.opt_state.state
                b1 = self.state.opt_state.param_groups[0]["betas"][0]
                self.grad1 = {
                    k: (ex[p]["exp_avg"] / (1.0 - b1)).norm().item()
                    if p in ex else 0.0 for k, p in names.items()}
        self.change = {k: (p.detach() - self.state0[k]).norm().item()
                       for k, p in names.items()}
        ctx.mark("first steps")

    def _step(self):
        """One step as the train CLI's loop takes it; returns the loss."""
        from trx2dy_torch.models.features import get_f2d
        msa_np, _, labels_np, mask_np = self.pool[self.n % len(self.pool)]
        dev = self.device
        msa = torch.as_tensor(msa_np[:self.tr["msa_rows"]],
                              dtype=torch.int64, device=dev)
        if self.ctx.fault == "rows":            # half the rows left out
            msa = msa[:len(msa) // 2]
        f2d = get_f2d(msa)
        labels = {k: torch.as_tensor(v, device=dev)[None]
                  for k, v in labels_np.items()}
        mask = torch.as_tensor(mask_np, device=dev)[None]
        if self.ctx.fault == "state":           # the state left unchanged
            with torch.no_grad():
                from trx2dy_torch.models.train import batched_loss
                loss = batched_loss(self.state.model, f2d[None], msa[None],
                                    labels, mask)
        else:
            self.state, loss = self.step_fn(self.state, f2d[None],
                                            msa[None], labels, mask)
        self.n += 1
        return float(loss)

    def round(self, rec):
        units = []
        fwd = counts.predictor2d_flops(self.tr["length"], self.tr["msa_rows"],
                                       self.cfg["depth"], self.cfg["dim"],
                                       self.cfg["in_dim"])
        for _ in range(self.tr["steps_per_round"]):
            t0 = time.perf_counter()
            with label("step", rec.profiled):
                self._step()
            t1 = time.perf_counter()
            units.append(Unit(t0, t1, 3.0 * fwd, profiled=rec.profiled))
        return units

    def free(self):
        self.state = self.step_fn = None

    def _reference_run(self):
        """(losses, first clipped gradient norms, change norms) of the
        plain reference's steps from the same weights on the same
        targets."""
        from plainref.features import get_f2d
        from plainref.predictor2d import DistPredictor
        from plainref.train import AdamW, geometry_loss, labels_from_structure
        cfg, dev = self.cfg, self.device
        model = DistPredictor(cfg["depth"], cfg["dim"], cfg["in_dim"])
        model.load_state_dict(self.state0)
        model = model.to(dev)
        names = dict(model.named_parameters())
        opt = AdamW(names.values(), lr=self.tr["lr"])
        losses, grad1 = [], None
        for n in range(self.tr["reference_steps"]):
            msa_np, coords, _, _ = self.pool[n % len(self.pool)]
            labels, mask = labels_from_structure(coords)
            msa = torch.as_tensor(msa_np[:self.tr["msa_rows"]],
                                  dtype=torch.int64, device=dev)
            model.zero_grad(set_to_none=True)
            loss = geometry_loss(model, get_f2d(msa), msa,
                                 {k: v.to(dev) for k, v in labels.items()},
                                 mask.to(dev), remat=True)
            loss.backward()
            losses.append(loss.item())
            grads = opt.step()
            if n == 0:
                grad1 = {k: g.norm().item() for k, g in zip(names, grads)}
        change = {k: (p.detach() - self.state0[k]).norm().item()
                  for k, p in names.items()}
        return losses, grad1, change

    @staticmethod
    def _gaps(losses, grad1, change, ref):
        r_losses, r_grad1, r_change = ref
        median = float(np.median(list(r_grad1.values())))
        counted = [k for k, v in r_grad1.items() if v >= MEDIAN_SHARE * median]
        med_change = float(np.median([r_change[k] for k in counted]))

        def worst(got, want, floor):
            return max(abs(got[k] - want[k]) / max(want[k], floor)
                       for k in counted)
        return {"loss_rel": max(abs(a - b) / abs(b)
                                for a, b in zip(losses, r_losses)),
                "grad1_leaf_rel": worst(grad1, r_grad1, median),
                "change_leaf_rel": worst(change, r_change, med_change)}

    def check(self, control=None):
        """The widest gaps to the reference over the reference steps: of
        the loss (relative), and by the worst counted leaf, of the first
        gradient's norm and of the parameters' change's norm, each
        relative to the reference leaf's or the median leaf's, whichever
        is larger. A leaf is counted where the reference's first gradient
        is at least MEDIAN_SHARE of the median leaf's."""
        from plainref import lowp
        ref = self._reference_run()
        out = self._gaps(self.losses, self.grad1, self.change, ref)
        if control is not None:
            with lowp.precision(control):
                low = self._reference_run()
            out["control"] = self._gaps(*low, ref)
        return out


def setup(ctx):
    return Train(ctx)
