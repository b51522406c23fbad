"""e2e requests: an MSA in, one structure out (atom14, pLDDT, geometry).

The system under test is what trx2dy_torch.cli.predict.main runs between
its `weights` and `write` stages: mymsa_to_esmmsa, ESMMSA.forward (layer
12's representations and every row attention), the CLI's guard on them,
Folding.forward with 3 recycles, and atom14, pLDDT and the geometry
copied to the host. The MSA's rows stay at or under the CLI's 1.1 x
nrows, so no hhfilter step runs; file reading, weights and file writing
are left out of the request.

Set-up: ESM-MSA-1b's and Folding's weights are drawn on the device from
the seed, the matrices in bf16 (the CLI's --bf16 default), and built by
models.convert.build_esm/build_folding; each length of the round then
runs once, the largest first, with one Folding cycle (every cycle runs
the same shapes), so that every shape the window uses is warm. The
check runs the plain reference in float32 (the same bf16-valued weights,
upcast) on a sample of the last round's
requests drawn from the seed, the longest among them.
"""
from __future__ import annotations

import time

import torch

from harness import counts, traffic
from harness.core import Unit
from harness.trace import label
from harness.weights import seeded_state, shapes_of, sub_seed, upcast


class E2E:
    def __init__(self, ctx):
        from trx2dy_torch.device import resolve_device
        from trx2dy_torch.models.convert import build_esm, build_folding
        from trx2dy_torch.models.esm_msa import ESMMSA
        from trx2dy_torch.models.folding_e2e import Folding
        from trx2dy_torch.models.structure_module import SMConfig

        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.cfg, self.tr = ctx, cfg, tr
        self.device = resolve_device(str(ctx.device))
        self.dtype = {"bfloat16": torch.bfloat16,
                      "float32": None}[cfg["precision"]]
        fold_kw = dict(cfg["folding"], sm=SMConfig(**cfg["folding"]["sm"]))
        with torch.device("meta"):
            esm_shapes = shapes_of(ESMMSA(**cfg["esm"]))
            fold_shapes = shapes_of(Folding(**fold_kw))
        gain = cfg["init_gain"]
        self.esm_state = seeded_state(esm_shapes, sub_seed(ctx.seed, "esm"),
                                      self.device, self.dtype, gain)
        self.fold_state = seeded_state(fold_shapes,
                                       sub_seed(ctx.seed, "folding"),
                                       self.device, self.dtype, gain)
        self.esm = build_esm(self.esm_state, self.device, self.dtype)
        self.folding = build_folding(self.fold_state, self.device,
                                     self.dtype)
        ctx.mark("weights")
        self.requests = traffic.make_round(tr, ctx.seed)
        longest = max(self.requests, key=lambda r: r.L)
        self.probe = longest.index
        self.sample = traffic.sample(len(self.requests), tr["sample"],
                                     ctx.seed, longest.index)
        self.last, self.probe_out = {}, None
        ctx.mark("inputs")
        for req in sorted(self.requests, key=lambda r: -r.L):
            self._request(req, None, cycles=1)  # every shape, largest first
        ctx.mark("warm-up")

    def _request(self, req, rec, timings=None, esm_ev=None, cycles=None):
        """One request, as the predict CLI runs it; returns its host
        outputs and its ESM outputs. cycles: run only that many of the
        Folding cycles (the warm-up: every cycle runs the same shapes)."""
        from trx2dy_torch.device import StageTimer
        from trx2dy_torch.models.esm_msa import mymsa_to_esmmsa
        msa = req.msa
        if self.ctx.fault == "rows":            # half the rows left out
            msa = msa[:len(msa) // 2]
        last = len(self.esm.layers)
        on = rec is not None and rec.profiled
        with torch.inference_mode():
            toks = torch.as_tensor(mymsa_to_esmmsa(msa), device=self.device)
            with label("esm", on):
                a = esm_ev.mark() if esm_ev else None
                emb = self.esm(toks, repr_layers=(last,),
                               need_head_weights=True)
                if esm_ev:
                    esm_ev.add(a, esm_ev.mark())
            reprs, attns = emb["representations"][last], emb["row_attentions"]
            if float(reprs.abs().max()) == 0.0 or \
                    float(attns.abs().max()) == 0.0:
                raise ValueError("ESM-MSA fails to generate embeddings")
            with label("folding", on):
                out = self.folding(
                    req.seq, toks, reprs, attns,
                    n_recycle=self.cfg["recycles"] if cycles is None
                    else cycles - 1,
                    msa_cutoff=self.cfg["nrows"],
                    timer=None if timings is None
                    else StageTimer(timings, self.device))
        with label("host_copy", on):
            host = {"plddt": out["plddt"].float().cpu().numpy(),
                    "geoms": {k: v.float().cpu().numpy()
                              for k, v in out["geoms"].items()},
                    "atom14": out["atom14"].float().cpu().numpy(),
                    "atom14_mask": out["atom14_mask"].cpu().numpy()}
        if self.ctx.fault == "answer":          # an answer altered: the
            host["atom14"][0] = host["atom14"][-1]  # first residue's atoms
        return host, (reprs, attns)

    def _flops(self, L: int) -> float:
        cfg = self.cfg
        R = min(self.tr["msa_rows"], cfg["nrows"])
        fold = dict(cfg["folding"])
        sm = fold.pop("sm")
        fold.pop("n_tokens", None)
        sm_kw = {k: sm[k] for k in ("c_s", "c_z", "c_ipa", "c_resnet")}
        sm_kw.update(heads=sm["no_heads_ipa"], qk_points=sm["no_qk_points"],
                     v_points=sm["no_v_points"], blocks=sm["no_blocks"],
                     transition_layers=sm["no_transition_layers"],
                     resnet_blocks=sm["no_resnet_blocks"],
                     angles=sm["no_angles"])
        esm = cfg["esm"]
        return counts.esm_flops(self.tr["msa_rows"], L + 1, esm["layers"],
                                esm["embed_dim"], esm["ffn_dim"],
                                esm["vocab"]) \
            + counts.folding_flops(L, R, 1 + cfg["recycles"], **fold,
                                   **sm_kw)

    def round(self, rec):
        units = []
        for req in self.requests:
            timings = [] if rec.trace and not rec.profiled else None
            esm_ev = rec.events if timings is not None else None
            t0 = time.perf_counter()
            host, esm_out = self._request(req, rec, timings, esm_ev)
            t1 = time.perf_counter()
            if req.index in self.sample:
                self.last[req.index] = host
            if req.index == self.probe:
                self.probe_out = esm_out
            bound = counts.roofline_bound_s(*counts.tri_attn_ops_bytes(
                req.L, self.ctx.peaks["element_bytes"]), self.ctx.peaks)
            launches = 2 * self.cfg["folding"]["depth"] \
                * (1 + self.cfg["recycles"])
            u = Unit(t0, t1, self._flops(req.L), [bound] * launches,
                     profiled=rec.profiled)
            if timings is not None:
                u.spans["esm_ms"] = [len(rec.events.pairs) - 1]
                u.spans["trunk_ms"] = 1e3 * sum(
                    s for k, s in timings if k.startswith("trunk_"))
                u.spans["structure_ms"] = 1e3 * sum(
                    s for k, s in timings if k.startswith("structure_"))
            units.append(u)
        return units

    def free(self):
        self.esm = self.folding = None

    def check(self, control=None):
        """The widest gaps of the sampled requests against the float32
        reference: ESM's layer-12 representations (relative to their
        largest magnitude) and row attentions of the longest request,
        and of every sampled request the geometry probabilities, the
        pLDDT and the atom14 coordinates (A, masked atoms); with control,
        the same gaps of the reference computed in that precision."""
        from plainref import lowp
        from plainref.esm_msa import ESMMSA, mymsa_to_esmmsa
        from plainref.folding import Folding
        from plainref.structure_module import SMConfig
        cfg = self.cfg
        esm_ref = ESMMSA(**cfg["esm"])
        esm_ref.load_state_dict(upcast(self.esm_state))
        fold_ref = Folding(**dict(cfg["folding"],
                                  sm=SMConfig(**cfg["folding"]["sm"])))
        fold_ref.load_state_dict(upcast(self.fold_state))
        esm_ref, fold_ref = (m.to(self.device).eval()
                             for m in (esm_ref, fold_ref))
        last = cfg["esm"]["layers"]

        def forward(req, msa):
            toks = torch.as_tensor(mymsa_to_esmmsa(msa), device=self.device)
            emb = esm_ref(toks, repr_layers=(last,), need_head_weights=True)
            reprs, attns = emb["representations"][last], \
                emb["row_attentions"]
            out = fold_ref(req.seq, toks, reprs, attns,
                           n_recycle=cfg["recycles"], msa_cutoff=cfg["nrows"])
            return reprs, attns, out

        def gaps(host, esm_out, ref, probe):
            reprs, attns, out = ref
            mask = out["atom14_mask"] > 0
            g = {"geom_prob_max_abs": max(
                (torch.as_tensor(host["geoms"][k], device=self.device)
                 - v.float()).abs().max().item()
                for k, v in out["geoms"].items()),
                "plddt_max_abs": (torch.as_tensor(host["plddt"],
                                                  device=self.device)
                                  - out["plddt"]).abs().max().item(),
                "atom14_max_abs": (torch.as_tensor(host["atom14"],
                                                   device=self.device)
                                   - out["atom14"])[mask].abs().max().item()}
            if probe:
                got_r, got_a = (t.float() for t in esm_out)
                same = got_r.shape == reprs.shape and \
                    got_a.shape == attns.shape
                g["esm_repr_rel"] = ((got_r - reprs).abs().max()
                                     / reprs.abs().max()).item() \
                    if same else float("inf")
                g["row_attn_max_abs"] = (got_a - attns).abs().max().item() \
                    if same else float("inf")
            return g

        worst, worst_c = {}, {}
        with torch.no_grad():
            for i in self.sample:
                req = self.requests[i]
                ref = forward(req, req.msa)
                host = self.last[i]
                esm_out = self.probe_out if i == self.probe else None
                for k, v in gaps(host, esm_out, ref, i == self.probe).items():
                    worst[k] = max(worst.get(k, 0.0), v)
                if control is not None:
                    with lowp.precision(control):
                        low = forward(req, req.msa)
                    low_host = {
                        "plddt": low[2]["plddt"].cpu().numpy(),
                        "geoms": {k: v.cpu().numpy()
                                  for k, v in low[2]["geoms"].items()},
                        "atom14": low[2]["atom14"].cpu().numpy()}
                    for k, v in gaps(low_host, low[:2], ref,
                                     i == self.probe).items():
                        worst_c[k] = max(worst_c.get(k, 0.0), v)
                del ref
        if control is not None:
            worst["control"] = worst_c
        return worst


def setup(ctx):
    return E2E(ctx)
