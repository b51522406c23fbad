"""Geometry requests: an MSA in, both models' softmaxed histograms out.

The system under test is trx2dy_torch.models.predictor2d_infer
.predict_geometry, called for the NMR model and then the X-ray model (as
dynamics/driver.geometry_stage runs them), each returning its histograms
to the host. The MSA file read, weight loading and npz writing of
geometry_stage are left out of the request.

Set-up: both models' weights are drawn on the device from the seed,
loaded into the port's DistPredictor, and each length of the round runs
once through one model, the largest first, so that every shape the
window uses is warm. The check runs the plain
reference (benchmarks/plainref: features, trunk with the logits
attention, heads, softmax) on a sample of the last round's requests
drawn from the seed, the longest among them, and reads the widest gap
between a program probability and the reference's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import counts, traffic
from harness.core import Unit
from harness.trace import ModuleSpan, label
from harness.weights import seeded_state, shapes_of, sub_seed


def _reference_model(config, state, device):
    from plainref.predictor2d import DistPredictor
    model = DistPredictor(config["depth"], config["dim"], config["in_dim"])
    model.load_state_dict(state)
    return model.to(device).eval()


class Geometry:
    def __init__(self, ctx):
        from trx2dy_torch.device import resolve_device
        from trx2dy_torch.models.convert import load_into
        from trx2dy_torch.models.predictor2d import DistPredictor

        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.cfg, self.tr = ctx, cfg, tr
        self.device = resolve_device(str(ctx.device))
        with torch.device("meta"):
            shapes = shapes_of(DistPredictor(cfg["depth"], cfg["dim"],
                                             cfg["in_dim"]))
        self.states, self.models, self.spans = {}, {}, {}
        for tag in cfg["models"]:
            state = seeded_state(shapes, sub_seed(ctx.seed, "weights", tag),
                                 self.device)
            with torch.device("meta"):
                model = DistPredictor(cfg["depth"], cfg["dim"],
                                      cfg["in_dim"])
            model = model.to_empty(device=self.device)
            load_into(model, state)
            self.states[tag], self.models[tag] = state, model.eval()
        ctx.mark("weights")
        self.requests = traffic.make_round(tr, ctx.seed)
        self.last = {}
        longest = max(self.requests, key=lambda r: r.L)
        self.sample = traffic.sample(len(self.requests), tr["sample"],
                                     ctx.seed, longest.index)
        ctx.mark("inputs")
        self._warm_up()
        ctx.mark("warm-up")

    def _warm_up(self):
        """Every length of the round once, the largest first, through one
        model (the other runs the same shapes)."""
        from trx2dy_torch.models.predictor2d_infer import predict_geometry
        model = self.models[self.cfg["models"][0]]
        for req in sorted(self.requests, key=lambda r: -r.L):
            predict_geometry(model, self._entry_msa(req))

    def _entry_msa(self, req):
        if self.ctx.fault == "rows":            # half the rows left out
            return req.msa[:len(req.msa) // 2]
        return req.msa

    def _request(self, req, rec=None):
        from trx2dy_torch.models.predictor2d_infer import predict_geometry
        out = {}
        for tag, model in self.models.items():
            with label("request", rec is not None and rec.profiled):
                out[tag] = predict_geometry(model, self._entry_msa(req))
        if self.ctx.fault == "answer":          # an answer altered
            d = out[self.cfg["models"][0]]["dist"]
            d[0, 1] = np.roll(d[0, 1], 1)
        return out

    def _hook(self, rec):
        for tag, model in self.models.items():
            blocks = model.net.net.blocks
            self.spans[tag] = ModuleSpan(rec.events, blocks[0], blocks[-1],
                                         "trunk")

    def round(self, rec):
        if rec.trace and not self.spans:
            self._hook(rec)
        units = []
        R = min(self.tr["msa_rows"], self.cfg["trunk_rows"])
        for req in self.requests:
            t0 = time.perf_counter()
            out = self._request(req, rec)
            t1 = time.perf_counter()
            if req.index in self.sample:
                self.last[req.index] = out
            flops = len(self.models) * counts.predictor2d_flops(
                req.L, R, self.cfg["depth"], self.cfg["dim"],
                self.cfg["in_dim"])
            bound = counts.roofline_bound_s(*counts.tri_attn_ops_bytes(
                req.L, self.ctx.peaks["element_bytes"]), self.ctx.peaks)
            launches = 2 * self.cfg["depth"] * len(self.models)
            u = Unit(t0, t1, flops, [bound] * launches,
                     profiled=rec.profiled)
            if self.spans:
                u.spans["trunk_ms"] = [i for s in self.spans.values()
                                       for i in s.take()]
            units.append(u)
        return units

    def free(self):
        for s in self.spans.values():
            s.remove()
        self.models = self.spans = None

    def check(self, control=None):
        """{'geom_prob_max_abs': the widest |program - reference| over
        every probability of the sampled requests}; with control (a
        lowp precision), also the same gap of the reference computed in
        it, {'control': {...}}."""
        from plainref import lowp
        from plainref.features import get_f2d
        worst, worst_c = 0.0, 0.0
        refs = {tag: _reference_model(self.cfg, s, self.device)
                for tag, s in self.states.items()}
        cap = self.cfg["trunk_rows"]
        with torch.no_grad():
            for i in self.sample:
                req = self.requests[i]
                tokens = torch.as_tensor(req.msa.astype(np.int64),
                                         device=self.device)
                f2d = get_f2d(tokens)
                for tag, model in refs.items():
                    ref = {k: torch.softmax(v, -1)
                           for k, v in model(f2d, tokens[:cap]).items()}
                    got = self.last[i][tag]
                    for k, v in ref.items():
                        gap = (torch.as_tensor(got[k], device=self.device)
                               - v).abs().max().item()
                        worst = max(worst, gap)
                    if control is not None:
                        with lowp.precision(control):
                            low = model(get_f2d(tokens), tokens[:cap])
                        for k, v in ref.items():
                            gap = (torch.softmax(low[k], -1) - v).abs() \
                                .max().item()
                            worst_c = max(worst_c, gap)
                    del ref
        out = {"geom_prob_max_abs": worst}
        if control is not None:
            out = {**out, "control": {"geom_prob_max_abs": worst_c}}
        return out


def setup(ctx):
    return Geometry(ctx)
