"""AlphaFold2 requests: an MSA with its deletion counts in, one structure
out (atom14, pLDDT, distogram).

The system under test is what `trx2dy_torch.cli.predict --arch af2` runs
between its `weights` and `write` stages, models/alphafold2.predict:
the features built on the device (the query and clusters - 1 centres
drawn from a seed, the rest as the extra MSA up to its cap, each extra
row assigned to its nearest centre), the model with its recycles (the
extra-MSA stack, the Evoformer, the structure module each cycle; the
distogram and pLDDT heads after the last), and atom14, its mask, pLDDT
and the distogram copied to the host. File reading, weights and writing
are left out of the request.

Each request's MSA is harness.synthetic's, with a deletion matrix drawn
here from the seed: every non-query entry carries a deletion with
probability `deletion_rate`, its count geometric with mean 2.

Set-up: the weights are drawn on the device from the seed, the matrices
in bf16, and built by models.convert.build_af2; each length of the round
then runs once with one cycle, the largest first, so every shape of the
window is warm; the sampled requests keep that first cycle's
distogram. The check runs the plain reference (plainref/alphafold2.py)
in float32 on the same bf16-valued weights, upcast, on a sample of the
last round's requests drawn from the seed, the longest among them, with
one cycle and with the cell's.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import counts, counts_af2, traffic
from harness.core import Unit
from harness.weights import seeded_state, shapes_of, sub_seed, upcast


# the widths the plain reference takes; its other sizes are the published
REF_WIDTHS = ("c_m", "c_z", "c_e", "c_s", "evoformer_blocks", "extra_blocks",
              "msa_heads", "msa_head_dim", "extra_heads", "extra_head_dim",
              "dist_bins", "plddt_hidden", "plddt_bins")


def deletions(msa: np.ndarray, rate: float, seed: int) -> np.ndarray:
    """(rows, L) int32 deletion counts for a synthetic MSA; none in the
    query."""
    rng = np.random.default_rng(seed)
    d = np.where(rng.random(msa.shape) < rate,
                 rng.geometric(0.5, msa.shape), 0).astype(np.int32)
    d[0] = 0
    return d


class AF2:
    def __init__(self, ctx):
        from trx2dy_torch.device import resolve_device
        from trx2dy_torch.models.alphafold2 import AF2Config, AlphaFold2
        from trx2dy_torch.models.convert import build_af2

        cfg, tr = ctx.config, ctx.traffic
        self.ctx, self.cfg, self.tr = ctx, cfg, tr
        self.device = resolve_device(str(ctx.device))
        self.dtype = {"bfloat16": torch.bfloat16,
                      "float32": None}[cfg["precision"]]
        self.widths = {k: cfg[k] for k in AF2Config._fields if k in cfg}
        with torch.device("meta"):
            shapes = shapes_of(AlphaFold2(AF2Config(**self.widths)))
        self.state = seeded_state(shapes, sub_seed(ctx.seed, "af2"),
                                  self.device, self.dtype, cfg["init_gain"])
        self.model = build_af2(self.state, self.device, self.dtype)
        ctx.mark("weights")
        self.requests = traffic.make_round(tr, ctx.seed)
        self.deletions = [deletions(r.msa, tr["deletion_rate"],
                                    sub_seed(ctx.seed, "deletions", r.index))
                          for r in self.requests]
        longest = max(self.requests, key=lambda r: r.L)
        self.sample = traffic.sample(len(self.requests), tr["sample"],
                                     ctx.seed, longest.index)
        self.last, self.first = {}, {}
        ctx.mark("inputs")
        for req in sorted(self.requests, key=lambda r: -r.L):
            host, _ = self._request(req, n_recycle=0)  # every shape,
            if req.index in self.sample:               # largest first
                self.first[req.index] = host["distogram"]
        ctx.mark("warm-up")

    def _rows(self, req):
        rows = len(req.msa)
        if self.ctx.fault == "rows":            # half the rows left out
            rows //= 2
        return rows

    def _request(self, req, n_recycle=None):
        """One request, as the predict CLI runs it: (host outputs, the
        forward's device outputs)."""
        from trx2dy_torch.models.alphafold2 import predict
        rows = self._rows(req)
        host, out = predict(
            self.model, req.msa[:rows], self.deletions[req.index][:rows],
            sub_seed(self.ctx.seed, "clusters", req.index),
            self.cfg["recycles"] if n_recycle is None else n_recycle,
            self.cfg["msa_clusters"], self.cfg["extra_msa"])
        if self.ctx.fault == "answer":          # an answer altered: the
            host["atom14"][0] = host["atom14"][-1]  # first residue's atoms
        return host, out

    def _flops(self, L: int) -> float:
        rows = self.tr["msa_rows"]
        N = min(rows, self.cfg["msa_clusters"])
        E = min(rows - N, self.cfg["extra_msa"])
        return counts_af2.af2_flops(L, N, E, 1 + self.cfg["recycles"],
                                    **self.widths)

    def _bounds(self, L: int, before: dict, stats) -> list:
        """The roofline bound of every kernel launch the request made, by
        use, from AF2_STATS."""
        peaks = self.ctx.peaks
        n_row = stats.launches["msa_row"] - before["msa_row"]
        rows = (stats.msa_row_rows - before["rows"]) // max(1, n_row)
        n_tri = sum(stats.launches[k] - before[k]
                    for k in ("tri_start", "tri_end"))
        row = counts_af2.msa_row_bound_s(rows, L, peaks,
                                         self.cfg["msa_heads"],
                                         self.cfg["msa_head_dim"])
        tri = counts.roofline_bound_s(*counts.tri_attn_ops_bytes(
            L, peaks["element_bytes"]), peaks)
        return [row] * n_row + [tri] * n_tri

    def round(self, rec):
        from trx2dy_torch.models.alphafold2 import AF2_STATS
        units = []
        for req in self.requests:
            before = dict(AF2_STATS.launches, rows=AF2_STATS.msa_row_rows)
            t0 = time.perf_counter()
            host, out = self._request(req)
            t1 = time.perf_counter()
            if req.index in self.sample:
                self.last[req.index] = (host, out["pair"],
                                        out["msa_first_row"])
            units.append(Unit(t0, t1, self._flops(req.L),
                              self._bounds(req.L, before, AF2_STATS),
                              profiled=rec.profiled))
        return units

    def free(self):
        self.model = None

    def check(self, control=None):
        """The widest gaps of the sampled requests against the float32
        reference: the first cycle's distogram probabilities (the
        warm-up's, before any recycled input: a recycled Cb distance
        that rounding moves across a bin edge moves the last cycle's
        probabilities as far as fp8 does), pLDDT and atom14 (A, masked
        atoms), max abs; the last cycle's pair representation and MSA
        first row, max abs over the reference's largest magnitude. With
        control, the same gaps of the reference computed in that
        precision."""
        from plainref import lowp
        from plainref.alphafold2 import AlphaFold2, predict
        cfg = self.cfg
        ref = AlphaFold2(**{k: self.widths[k] for k in REF_WIDTHS})
        ref.load_state_dict(upcast(self.state))
        ref = ref.to(self.device).eval()

        def forward(req, n_recycle=cfg["recycles"]):
            return predict(ref, req.msa, self.deletions[req.index],
                           sub_seed(self.ctx.seed, "clusters", req.index),
                           n_recycle, cfg["msa_clusters"], cfg["extra_msa"],
                           self.device)

        def rel(a, b):
            return float(((a.float() - b).abs().max()
                          / b.abs().max()).item())

        def gaps(host, pair, m1, first, want, want_first):
            mask = want["atom14_mask"] > 0
            dev = self.device
            return {
                "distogram_first_max_abs": (torch.as_tensor(
                    first, device=dev) - want_first).abs().max().item(),
                "plddt_max_abs": (torch.as_tensor(host["plddt"], device=dev)
                                  - want["plddt"]).abs().max().item(),
                "atom14_max_abs": (torch.as_tensor(host["atom14"], device=dev)
                                   - want["atom14"])[mask].abs().max()
                .item(),
                "pair_rel": rel(pair, want["pair"]),
                "msa_first_row_rel": rel(m1, want["msa_first_row"])}

        worst, worst_c = {}, {}
        with torch.no_grad():
            for i in self.sample:
                req = self.requests[i]
                want_first = forward(req, 0)["distogram"]
                want = forward(req)
                for k, v in gaps(*self.last[i], self.first[i], want,
                                 want_first).items():
                    worst[k] = max(worst.get(k, 0.0), v)
                if control is not None:
                    with lowp.precision(control):
                        low_first = forward(req, 0)["distogram"]
                        low = forward(req)
                    low_host = {k: low[k].cpu().numpy() for k in
                                ("plddt", "atom14")}
                    for k, v in gaps(low_host, low["pair"],
                                     low["msa_first_row"], low_first, want,
                                     want_first).items():
                        worst_c[k] = max(worst_c.get(k, 0.0), v)
                    del low, low_first
                del want, want_first
        if control is not None:
            worst["control"] = worst_c
        return worst


def setup(ctx):
    return AF2(ctx)
