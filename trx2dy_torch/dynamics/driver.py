"""The Dynamics pipeline driver, run_inference.py's counterpart.

Port of trx2dy/dynamics/driver.py (reference run_inference.py:16-337).
Per target: the geometry stage (a3m -> Predictor2D -> pred_npz for the
NMR and X-ray models), an initial ensemble, then chains of
fold -> measure -> dampen until the tmp channel's largest change drops
below CONVERGE_TOL or Nmax decoys are written; finally the output tree is
flattened and the decoys renamed conf_1_k / conf_2_k.

File contracts (resumable, SURVEY.md section 5):
  save_dir/<name>/pred_npz/<name>_{NMR,Xray}.npz     predicted histograms
  save_dir/<name>/tmp_npz/[NMR|Xray/]<name><k>.npz   per-iteration npz
  save_dir/<name>/pred_pdb/...                       decoys, renamed at end
  save_dir/<name>/traces.jsonl                       per-decoy and per-step
  (tmp_npz is removed when the run completes, as in the reference)

By default (DynamicsConfig) both models' n_chains chains fold together as
one batched fold per step (fold_chains_pool: per-lane tables built on the
device, the spline kernel's lanes entry), the initial ensembles fold in
the same lane bucket, and files are written on a thread pool while the
next step runs. The chain state (dampened histograms) stays on the
device; the host reads the counts, the energies for the candidate pick,
the convergence deltas and the decoys. Random numbers come from a
torch.Generator seeded from cfg.seed, so decoys match the JAX package in
distribution, not bit for bit. An interrupted run's tmp_npz tree resumes
on the sequential sampler (generate_ensemble on fold_ensemble), whose
per-file resume contract is exact.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch

from trx2dy_torch.device import resolve_device
from trx2dy_torch.dynamics.loop import (
    GeomHistograms, convergence_delta, dampen_step, histograms_from_npz,
    histograms_to_npz, measure_decoy, reliability_score,
)
from trx2dy_torch.io.a3m import read_fasta
from trx2dy_torch.io.pdbio import write_pdb_atom14, write_pdb_backbone
from trx2dy_torch.models.predictor2d_infer import pred_2d_geometry
from trx2dy_torch.physics.folder import (
    FoldResult, _bucket_size, fold_chains_pool, fold_ensemble,
)
from trx2dy_torch.physics.minimize import STATS, host_numpy, host_sync
from trx2dy_torch.physics.sidechain import (
    detect_disulfides, pack_and_write, pack_ensemble,
)

WEIGHT_FILES = {"NMR": "trX2(NMR)_40.pth", "Xray": "trX2(X-ray)_40.pth"}
CONVERGE_TOL = 0.01   # max |delta tmp| (run_inference.py:135-137)
PACK_CHUNK = 8        # decoys packed per batch when writing full-atom PDBs


def geometry_npz(name: str, tag: str, msa_file: Optional[str],
                 save_npz_dir: str, npz_dir: Optional[str] = None,
                 model_dir: Optional[str] = None, device="cuda") -> str:
    """Path of <save_npz_dir>/<name>_<tag>.npz, made if it is missing: an
    existing file is reused, else <npz_dir>/<name>_<tag>.npz is copied,
    else Predictor2D runs with the tag's weight file from model_dir."""
    target = os.path.join(save_npz_dir, f"{name}_{tag}.npz")
    if os.path.exists(target):
        return target
    if npz_dir:
        src = os.path.join(npz_dir, f"{name}_{tag}.npz")
        if os.path.exists(src):
            shutil.copy(src, target)
            return target
    if model_dir is None:
        raise FileNotFoundError(
            f"no precomputed npz for {name}_{tag} and no model_dir given")
    pred_2d_geometry(os.path.join(model_dir, WEIGHT_FILES[tag]), msa_file,
                     save_npz_dir, f"{name}_{tag}", device=device)
    return target


def geometry_stage(name: str, msa_file: Optional[str], save_dir: str,
                   npz_dir: Optional[str] = None,
                   model_dir: Optional[str] = None,
                   device="cuda") -> Dict[str, str]:
    """{tag: npz path} under <save_dir>/<name>/pred_npz for both models."""
    dev = resolve_device(device)
    save_npz_dir = os.path.join(save_dir, name, "pred_npz")
    os.makedirs(save_npz_dir, exist_ok=True)
    return {tag: geometry_npz(name, tag, msa_file, save_npz_dir, npz_dir,
                              model_dir, dev)
            for tag in WEIGHT_FILES}


class TraceWriter:
    """Appends one JSON line per folded decoy (energy, reliability,
    convergence delta) and per sampler phase (wall seconds t_*, with the
    phase's spline-counted energy evaluations and host syncs) to
    save_dir/<name>/traces.jsonl. The reference only prints progress
    (run_inference.py:48,103); no file contract changes."""

    def __init__(self, path: Optional[str]):
        self.path = path

    def write(self, **row):
        if self.path is None:
            return
        with open(self.path, "a") as f:
            f.write(json.dumps(
                {k: (float(v) if isinstance(v, (np.floating, np.ndarray))
                     else v) for k, v in row.items()}) + "\n")


@dataclass
class DynamicsConfig:
    """Driver options (reference argparse defaults, run_inference.py:356-380,
    and the folding CLI's, utils_ros/arguments.py)."""
    init_num: int = 10
    Nmax: int = 300
    angle: bool = True
    mult_two_models: bool = True
    sigma: float = 1.0
    mode: int = 2
    fastrelax: bool = True
    max_iter: int = 1000
    seed: int = 0
    # dampening chains per model, folded together as one batch per step
    # (the reference's sampler is one strictly sequential chain,
    # run_inference.py:97-139); n_chains=1 with combine_models=False is the
    # reference's sequential sampler and its per-file resume contract
    n_chains: int = 8
    # both models' chains in one batched fold per step (the reference runs
    # the two samplers one after the other, run_inference.py:298-302,
    # 334-339); a resume in progress takes the serial samplers
    combine_models: bool = True
    # full-atom decoys (sidechain packing); None follows fastrelax, as the
    # reference dumps full-atom poses after FastRelax (folding.py:220,273)
    full_atom: Optional[bool] = None
    # energy-gated selection: initial ensembles fold ceil(N (1 + oversample))
    # lanes per model and keep the N of lowest energy; each chain step
    # folds chain_candidates lanes per chain and keeps the best
    oversample: float = 0.25
    chain_candidates: int = 2
    # the combined sampler buckets its folded lanes so the initial fold and
    # the chain steps share one lane count; fill_candidates spends the
    # bucket's spare lanes as extra candidates per chain
    fill_candidates: bool = True
    # pad targets to a multiple of this length (0 = off)
    len_bucket: int = 0
    fold_kwargs: dict = field(default_factory=dict)

    @property
    def emit_full_atom(self) -> bool:
        return self.fastrelax if self.full_atom is None else self.full_atom


def _hist_npz(hist: GeomHistograms) -> dict:
    return {k: getattr(hist, k).cpu().numpy()
            for k in ("dist", "omega", "theta", "phi")}


def _fold_and_write(hist: GeomHistograms, seq: str, generator,
                    n_decoys: int, out_paths, cfg: DynamicsConfig, dev):
    """Fold n_decoys from the histograms, write their PDBs and return the
    FoldResult."""
    pad_to = None
    if cfg.len_bucket:
        pad_to = -(-len(seq) // cfg.len_bucket) * cfg.len_bucket
    res = fold_ensemble(_hist_npz(hist), seq, generator, n_decoys=n_decoys,
                        mode=cfg.mode, use_orient=cfg.angle,
                        fastrelax=cfg.fastrelax, max_iter=cfg.max_iter,
                        oversample=cfg.oversample, pad_to=pad_to,
                        device=dev, **cfg.fold_kwargs)
    if cfg.emit_full_atom:
        # sidechains pack onto the (cart-refined) folded backbone
        pack_and_write(out_paths, seq, res.torsions, backbone=res.atoms,
                       device=dev)
    else:
        atoms_np = {k: host_numpy(v) for k, v in res.atoms.items()}
        for b, path in enumerate(out_paths):
            write_pdb_backbone(path, seq,
                               {k: v[b] for k, v in atoms_np.items()})
    return res


def _measure(res, b: int):
    """One-hot histograms of decoy b of a FoldResult."""
    a = res.atoms
    return measure_decoy(a["N"][b], a["CA"][b], a["C"][b], a["CB"][b])


def generate_ensemble(pdb_name: str, processed_npz_dir: str,
                      pred_pdb_dir: str, initial_npz, seq: str,
                      cfg: DynamicsConfig,
                      generator: Optional[torch.Generator] = None,
                      begin_num: int = 0,
                      trace: Optional[TraceWriter] = None,
                      device="cuda") -> int:
    """The reference's generate_npz_and_pdb (run_inference.py:16-144) for
    one model: an initial ensemble, then dampening from the most reliable
    decoy. With cfg.n_chains > 1 and no resume in progress, cfg.n_chains
    chains run batched (_generate_ensemble_chains); otherwise one
    sequential chain whose per-file resume contract is exact. Returns the
    index of the last decoy written."""
    dev = resolve_device(device)
    resuming = os.path.isdir(processed_npz_dir) and any(
        f.startswith(pdb_name) and f.endswith(".npz")
        for f in os.listdir(processed_npz_dir))
    if cfg.n_chains > 1 and not resuming:
        return _generate_ensemble_chains(pdb_name, processed_npz_dir,
                                         pred_pdb_dir, initial_npz, seq,
                                         cfg, generator, begin_num, trace,
                                         dev)
    # An in-progress tmp_npz tree takes the sequential sampler: it refolds
    # each saved iteration from that file's own histograms, then continues
    # as one chain from the latest state (run_inference.py:100-102).
    trace = trace or TraceWriter(None)
    os.makedirs(processed_npz_dir, exist_ok=True)
    os.makedirs(pred_pdb_dir, exist_ok=True)
    if isinstance(initial_npz, (str, os.PathLike)):
        with np.load(initial_npz) as f:
            initial_npz = dict(f)
    hist = histograms_from_npz(initial_npz, dev)

    # initial ensemble: one batched fold of N decoys
    N = cfg.init_num
    init_paths = [os.path.join(pred_pdb_dir, f"initial{i}.pdb")
                  for i in range(N)]
    res = _fold_and_write(hist, seq, generator, N, init_paths, cfg, dev)
    scores = host_numpy(reliability_score(res.torsions))
    best = int(np.argmax(scores))
    e_np = host_numpy(res.energy)
    for i in range(N):
        trace.write(decoy=f"initial{i}", kind="initial",
                    energy=float(e_np[i]), reliability=float(scores[i]),
                    selected_seed=(i == best))

    # first dampening from the most reliable initial decoy
    hist = dampen_step(hist, _measure(res, best), sigma=cfg.sigma,
                       angle=cfg.angle)
    npz_pattern = os.path.join(processed_npz_dir, pdb_name + "{k}.npz")
    np.savez_compressed(npz_pattern.format(k=begin_num + 1),
                        **histograms_to_npz(hist))

    iter_n = begin_num
    old_tmp = hist      # holds the tmp of the convergence difference
    while True:
        iter_n += 1
        current = npz_pattern.format(k=iter_n)
        if os.path.exists(current):   # resume (run_inference.py:100)
            with np.load(current) as f:
                hist = histograms_from_npz(dict(f), dev)
            old_tmp = hist
        pdb_path = os.path.join(pred_pdb_dir, f"{pdb_name}{iter_n}.pdb")
        res = _fold_and_write(hist, seq, generator, 1, [pdb_path], cfg, dev)
        energy = float(host_numpy(res.energy)[0])
        if iter_n - begin_num >= cfg.Nmax:
            trace.write(decoy=f"{pdb_name}{iter_n}", kind="chain",
                        energy=energy, stopped="Nmax")
            break
        new_hist = dampen_step(hist, _measure(res, 0), sigma=cfg.sigma,
                               angle=cfg.angle)
        np.savez_compressed(npz_pattern.format(k=iter_n + 1),
                            **histograms_to_npz(new_hist))
        delta = convergence_delta(old_tmp, new_hist)
        trace.write(decoy=f"{pdb_name}{iter_n}", kind="chain",
                    energy=energy, delta=delta)
        hist = old_tmp = new_hist
        if delta < CONVERGE_TOL:
            break
    return iter_n


def flatten_directory(parent: str) -> None:
    """Move the files of subdirectories up into parent, suffixing '_1' on a
    clash (run_inference.py:145-168 move_and_delete_subfolders)."""
    for root, dirs, files in os.walk(parent, topdown=False):
        for name in files:
            if name.startswith("."):
                continue        # provisional and hidden files never ship
            src = os.path.join(root, name)
            dst = os.path.join(parent, name)
            if src == dst:
                continue
            if os.path.exists(dst):
                base, ext = os.path.splitext(name)
                c = 1
                while os.path.exists(dst):
                    dst = os.path.join(parent, f"{base}_{c}{ext}")
                    c += 1
            shutil.move(src, dst)
        for name in dirs:
            try:
                os.rmdir(os.path.join(root, name))
            except OSError:
                pass


def rename_to_conf(folder: str, num_conf1_others: int) -> None:
    """Rename decoys to the conf_1_k / conf_2_k contract
    (run_inference.py:170-278 rename_pdb_files, with its lexicographic
    order of the 'other' decoys)."""
    if not os.path.isdir(folder):
        return
    pat_init = re.compile(r"initial(\d+)\.pdb$", re.IGNORECASE)
    pat_init1 = re.compile(r"initial(\d+)_1\.pdb$", re.IGNORECASE)
    pat_c1 = re.compile(r"conf_1_(\d+)\.pdb$", re.IGNORECASE)
    pat_c2 = re.compile(r"conf_2_(\d+)\.pdb$", re.IGNORECASE)
    pat_num = re.compile(r".*(\d+)\.pdb$", re.IGNORECASE)

    init_x, init_x1, others = [], [], []
    max_c1 = max_c2 = max_proj_c1 = 0
    for fn in os.listdir(folder):
        if not fn.lower().endswith(".pdb") or fn.startswith("."):
            continue   # dotfiles are provisional or hidden, never decoys
        if (m := pat_c1.match(fn)):
            max_c1 = max(max_c1, int(m.group(1)))
        elif (m := pat_c2.match(fn)):
            max_c2 = max(max_c2, int(m.group(1)))
        elif (m := pat_init1.match(fn)):   # _1 before the plain initial
            init_x1.append((fn, int(m.group(1))))
        elif (m := pat_init.match(fn)):
            x = int(m.group(1))
            init_x.append((fn, x))
            max_proj_c1 = max(max_proj_c1, x + 1)
        elif pat_num.match(fn):
            others.append(fn)

    existing_c1_from_others = sum(
        1 for fn in os.listdir(folder)
        if (m := pat_c1.match(fn)) and int(m.group(1)) > max_proj_c1)

    plan: dict = {}
    for fn, x in sorted(init_x, key=lambda t: t[1]):
        plan[fn] = f"conf_1_{x + 1}.pdb"
        max_c1 = max(max_c1, x + 1)
    for fn, x in sorted(init_x1, key=lambda t: t[1]):
        plan[fn] = f"conf_2_{x + 1}.pdb"
        max_c2 = max(max_c2, x + 1)

    c1_next, c2_next = max_c1 + 1, max_c2 + 1
    budget = max(0, num_conf1_others - existing_c1_from_others)
    for i, fn in enumerate(sorted(others)):
        if i < budget:
            plan[fn] = f"conf_1_{c1_next}.pdb"
            c1_next += 1
        else:
            plan[fn] = f"conf_2_{c2_next}.pdb"
            c2_next += 1

    for old, new in plan.items():
        src, dst = os.path.join(folder, old), os.path.join(folder, new)
        if src != dst and not os.path.exists(dst):
            os.rename(src, dst)


def run_single(name: str, fasta_file: str, msa_file: Optional[str],
               save_dir: str, cfg: DynamicsConfig,
               npz_dir: Optional[str] = None,
               model_dir: Optional[str] = None, device="cuda") -> str:
    """The whole per-target pipeline (run_inference.py:280-337 run_single)
    on `device`; returns save_dir/name.

    The 2D geometry comes from, in order: an existing
    <save_dir>/<name>/pred_npz/<name>_{NMR,Xray}.npz, a copy from npz_dir,
    or Predictor2D with the weights in model_dir (geometry_npz)."""
    dev = resolve_device(device)
    save_content = os.path.join(save_dir, name)
    save_npz_dir = os.path.join(save_content, "pred_npz")
    save_pdb_dir = os.path.join(save_content, "pred_pdb")
    npz_tmp_dir = os.path.join(save_content, "tmp_npz")
    for d in (save_npz_dir, save_pdb_dir, npz_tmp_dir):
        os.makedirs(d, exist_ok=True)

    seq = read_fasta(fasta_file)
    seeds = torch.randint(2 ** 62, (2,),
                          generator=torch.Generator().manual_seed(cfg.seed))
    gen1, gen2 = (torch.Generator().manual_seed(int(s)) for s in seeds)

    def npz_for(tag: str) -> str:
        return geometry_npz(name, tag, msa_file, save_npz_dir, npz_dir,
                            model_dir, dev)

    def load(path):
        with np.load(path) as f:
            return histograms_from_npz(dict(f), dev)

    trace = TraceWriter(os.path.join(save_content, "traces.jsonl"))
    if cfg.mult_two_models:
        n1, n2 = npz_for("NMR"), npz_for("Xray")
        # a resume in progress takes the serial samplers, whose per-file
        # resume contract is exact (run_inference.py:100-102)
        resuming = any(
            f.startswith(name) and f.endswith(".npz")
            for tag in ("NMR", "Xray")
            if os.path.isdir(os.path.join(npz_tmp_dir, tag))
            for f in os.listdir(os.path.join(npz_tmp_dir, tag)))
        if cfg.combine_models and not resuming:
            streams = [
                _ModelStream(tag="NMR",
                             npz_dir=os.path.join(npz_tmp_dir, "NMR"),
                             pdb_dir=os.path.join(save_pdb_dir, "NMR"),
                             hist=load(n1), begin=0),
                _ModelStream(tag="Xray",
                             npz_dir=os.path.join(npz_tmp_dir, "Xray"),
                             pdb_dir=os.path.join(save_pdb_dir, "Xray"),
                             hist=load(n2)),
            ]
            num = _generate_chains_multi(name, streams, seq, cfg, gen1,
                                         trace=trace, device=dev)[0]
        else:
            num = generate_ensemble(name, os.path.join(npz_tmp_dir, "NMR"),
                                    os.path.join(save_pdb_dir, "NMR"), n1,
                                    seq, cfg, gen1, trace=trace, device=dev)
            generate_ensemble(name, os.path.join(npz_tmp_dir, "Xray"),
                              os.path.join(save_pdb_dir, "Xray"), n2, seq,
                              cfg, gen2, begin_num=num, trace=trace,
                              device=dev)
    else:
        n1 = npz_for("NMR")
        num = generate_ensemble(name, npz_tmp_dir,
                                os.path.join(save_pdb_dir, "NMR"), n1, seq,
                                cfg, gen1, trace=trace, device=dev)

    shutil.rmtree(npz_tmp_dir, ignore_errors=True)
    flatten_directory(save_pdb_dir)
    rename_to_conf(save_pdb_dir, num)
    return save_content


class _AsyncIO:
    """PDB and npz writes on a small thread pool, overlapping the next
    step's fold; drained before the output tree is flattened and renamed.
    A failed write re-raises at the next check() or at drain()."""

    def __init__(self, workers: int = 2):
        from concurrent.futures import ThreadPoolExecutor
        self._ex = ThreadPoolExecutor(max_workers=workers)
        self._futs = []

    def submit(self, fn, *args, **kwargs):
        self._futs.append(self._ex.submit(fn, *args, **kwargs))

    def drain(self):
        futs, self._futs = self._futs, []
        for f in futs:
            f.result()

    def check(self):
        """Re-raise from any write that has finished, without blocking:
        called once per sampler step, so a failing disk shows after one
        step."""
        done = [f for f in self._futs if f.done()]
        self._futs = [f for f in self._futs if not f.done()]
        for f in done:
            f.result()

    def close(self, raise_errors: bool = True):
        try:
            self.drain()
        except BaseException:
            self._ex.shutdown(wait=False)
            if raise_errors:
                raise
        else:
            self._ex.shutdown()


def _stack_hists(hists) -> GeomHistograms:
    return GeomHistograms(*(torch.stack(xs) for xs in zip(*hists)))


def _chain_update_batch(chains: GeomHistograms, n, ca, c, cb, advance,
                        sigma: float, angle: bool):
    """Measure and dampen every chain lane at once. chains: stacked (C, ...)
    histograms; n/ca/c/cb: (C, L, 3) decoy atoms; advance: (C,) bool, the
    lanes that advance (the others keep their histograms). Returns
    (new chains, per-lane max |delta tmp|, run_inference.py:135-137)."""
    fact = measure_decoy(n, ca, c, cb)
    new = dampen_step(chains, fact, sigma=sigma, angle=angle)
    delta = torch.amax(torch.abs(chains.tmp - new.tmp), dim=(1, 2, 3))

    def sel(a, b):
        return torch.where(advance.view((-1,) + (1,) * (a.dim() - 1)), b, a)
    return GeomHistograms(*(sel(a, b) for a, b in zip(chains, new))), delta


@dataclass
class _ModelStream:
    """One restraint model's sampler state in the combined loop."""
    tag: str                     # "NMR" / "Xray" / "" (one model)
    npz_dir: str                 # its tmp_npz subdirectory
    pdb_dir: str                 # its pred_pdb subdirectory
    hist: GeomHistograms         # initial (predicted) histograms
    begin: Optional[int] = None  # known begin_num; None = after prev stream


def _generate_chains_multi(pdb_name: str, streams, seq: str,
                           cfg: DynamicsConfig,
                           generator: Optional[torch.Generator] = None,
                           trace: Optional[TraceWriter] = None,
                           device="cuda") -> list:
    """The batched sampler over one or more restraint models: len(streams)
    x n_chains dampening chains fold as one batch per step
    (fold_chains_pool), each lane with its own tables, and every file
    write overlaps the next step's fold.

    Per stream the files are those of the serial sampler (initial{i}.pdb,
    <name>{k}.pdb, tmp_npz <name>{k}.npz with k continuing across
    streams). A stream whose first index waits on an earlier stream's
    count writes under provisional .tmp_s* names, renamed once the count
    is known: the final layout is the reference's serial NMR-then-Xray one
    (run_inference.py:334-339). Returns each stream's final index."""
    dev = resolve_device(device)
    trace = trace or TraceWriter(None)
    M = len(streams)
    K = cfg.n_chains
    N = cfg.init_num
    C = M * K
    L_true = len(seq)
    pad_to = None
    if cfg.len_bucket:
        pad_to = -(-L_true // cfg.len_bucket) * cfg.len_bucket
    padded = pad_to is not None and pad_to > L_true
    seq_fold = seq + "A" * (pad_to - L_true) if padded else seq
    res_mask = (torch.arange(len(seq_fold), device=dev) < L_true
                if padded else None)
    for s in streams:
        os.makedirs(s.npz_dir, exist_ok=True)
        os.makedirs(s.pdb_dir, exist_ok=True)
        # an interrupted run's provisional files must not reach this run's
        # renaming
        for d in (s.npz_dir, s.pdb_dir):
            for f in os.listdir(d):
                if f.startswith(".tmp_s"):
                    os.remove(os.path.join(d, f))
    io = _AsyncIO()

    def _pad_hist(h: GeomHistograms) -> GeomHistograms:
        # padded once: zero histograms never activate a restraint and stay
        # zero under dampening; res_mask zeroes every physics term
        if not padded:
            return h
        p = pad_to - L_true
        return GeomHistograms(*(torch.nn.functional.pad(
            v.to(dev), (0, 0, 0, p, 0, p)) for v in h))

    def write_decoys(fr, lanes, paths):
        """Write the given lanes' decoys, sliced to the true length;
        sidechains are packed (full-atom output) for these lanes only, in
        batches of PACK_CHUNK."""
        if cfg.emit_full_atom:
            sel = torch.as_tensor(lanes, device=dev)
            t = fr.torsions[sel][:, :, :L_true]
            bb = {k: v[sel][:, :L_true] for k, v in fr.atoms.items()}
            # one disulfide pairing for the whole written set (the
            # ensemble-mean CB, pack_ensemble's own rule)
            pairs = detect_disulfides(host_numpy(bb["CB"].mean(0)), seq)
            for c0 in range(0, len(lanes), PACK_CHUNK):
                part = slice(c0, c0 + PACK_CHUNK)
                xyz14, mask14, _ = pack_ensemble(
                    t[part], seq, pairs=pairs,
                    backbone={k: v[part] for k, v in bb.items()},
                    device=dev)
                xyz14, mask14 = host_numpy(xyz14), host_numpy(mask14)
                for j, path in enumerate(paths[part]):
                    io.submit(write_pdb_atom14, path, seq, xyz14[j], mask14)
        else:
            atoms_np = {a: host_numpy(v[:, :L_true])
                        for a, v in fr.atoms.items()}
            for lane, path in zip(lanes, paths):
                io.submit(write_pdb_backbone, path, seq,
                          {a: v[lane] for a, v in atoms_np.items()})

    # chain (i, k) lives at pool row i*K + k; every chain of stream i
    # starts from the stream's predicted histograms
    chains = _stack_hists([_pad_hist(s.hist) for s in streams
                           for _ in range(K)])

    def pool_dict():
        return {f: getattr(chains, f)
                for f in ("dist", "omega", "theta", "phi")}

    # initial ensembles: one fold for all streams, in the chain steps'
    # lane bucket; the pair-list floors hold the step shapes
    floors: dict = {}
    n_init = int(np.ceil(N * (1.0 + cfg.oversample)))
    cand = cfg.chain_candidates
    lane_bucket = _bucket_size(max(M * n_init, C * cand))
    if cfg.fill_candidates and lane_bucket // C > cand:
        # the bucket's spare lanes become extra candidates per chain
        cand = lane_bucket // C
    fold_kw = dict(mode=cfg.mode, use_orient=cfg.angle,
                   fastrelax=cfg.fastrelax, max_iter=cfg.max_iter,
                   bucket_floors=floors, res_mask=res_mask,
                   lane_bucket=lane_bucket, **cfg.fold_kwargs)
    t0 = time.perf_counter()
    counted = (STATS.evals, STATS.syncs)
    init_map = [i * K for i in range(M) for _ in range(n_init)]
    tm_fold: dict = {}
    fr_all = fold_chains_pool(pool_dict(), init_map, seq_fold, generator,
                              candidates=1, timings=tm_fold, **fold_kw)
    # per-stream energy gating (fold_ensemble's oversample): each stream's
    # N lowest-energy lanes, in energy order
    e_all = host_numpy(fr_all.energy)
    keep = np.concatenate([
        i * n_init + np.argsort(e_all[i * n_init:(i + 1) * n_init])[:N]
        for i in range(M)])
    keep_dev = torch.as_tensor(keep, device=dev)
    fr = FoldResult(torsions=fr_all.torsions[keep_dev],
                    energy=fr_all.energy[keep_dev],
                    atoms={k: v[keep_dev] for k, v in fr_all.atoms.items()})
    host_sync(dev)
    t_fold = time.perf_counter() - t0
    init_lanes = list(range(M * N))
    init_paths = [os.path.join(streams[i].pdb_dir, f"initial{j}.pdb")
                  for i in range(M) for j in range(N)]
    t0 = time.perf_counter()
    write_decoys(fr, init_lanes, init_paths)
    trace.write(kind="phase", step="initial", t_fold=round(t_fold, 3),
                t_emit=round(time.perf_counter() - t0, 3), **tm_fold,
                energy_evals=STATS.evals - counted[0],
                host_syncs=STATS.syncs - counted[1])
    scores = host_numpy(reliability_score(fr.torsions[:, :, :L_true]))
    e_np = host_numpy(fr.energy)

    # chain (i, k) starts from stream i's k-th most reliable initial decoy
    seed_lanes = []
    for i, s in enumerate(streams):
        order = np.argsort(scores[i * N:(i + 1) * N])[::-1][:K]
        for j in range(N):
            trace.write(decoy=f"initial{j}", kind="initial", model=s.tag,
                        energy=float(e_np[i * N + j]),
                        reliability=float(scores[i * N + j]),
                        selected_seed=bool(j in order))
        seed_lanes += [i * N + int(order[k % len(order)]) for k in range(K)]
    seed_dev = torch.as_tensor(seed_lanes, device=dev)
    a = fr.atoms
    chains, _ = _chain_update_batch(
        chains, *(a[k].index_select(0, seed_dev)
                  for k in ("N", "CA", "C", "CB")),
        torch.ones((C,), dtype=torch.bool, device=dev), cfg.sigma, cfg.angle)

    # first indices: stream 0's is known now, a later stream's once the
    # stream before it has finished (the reference's begin_num chaining)
    begins: list = [s.begin for s in streams]
    if begins[0] is None:
        begins[0] = 0
    produced = [0] * M
    active = np.ones((M, K), bool)
    renames: list = []           # (provisional path, stream, index, ext)

    def out_name(i: int, k: int, d: str, ext: str) -> str:
        if begins[i] is not None:
            return os.path.join(d, f"{pdb_name}{begins[i] + k}{ext}")
        path = os.path.join(d, f".tmp_s{i}_{k}{ext}")
        renames.append((path, i, k, ext))
        return path

    def save_hist_npz(path, snapshot, c):
        # the reference's tmp_npz key set; runs on the I/O pool, so the
        # copy of this chain's histograms to the host overlaps the next
        # step's fold (the snapshot keeps the step's tensors alive)
        arrs = {}
        for f in GeomHistograms._fields:
            v = getattr(snapshot, f)[c]
            arrs[f] = (v[:L_true, :L_true] if padded else v).cpu().numpy()
        np.savez_compressed(path, **arrs)

    for i in range(M):
        io.submit(save_hist_npz, out_name(i, 1, streams[i].npz_dir, ".npz"),
                  chains, i * K)

    # the batched sampling loop
    try:
        while True:
            io.check()           # a failed write shows after one step
            writing = np.zeros((M, K), bool)
            for i in range(M):
                act = np.where(active[i])[0]
                writing[i, act[:max(0, cfg.Nmax - produced[i])]] = True
            if not writing.any():
                break
            t0 = time.perf_counter()
            counted = (STATS.evals, STATS.syncs)
            tm_fold = {}
            fr = fold_chains_pool(pool_dict(), np.arange(C), seq_fold,
                                  generator, candidates=cand,
                                  timings=tm_fold, growth_buckets=True,
                                  **fold_kw)
            host_sync(dev)
            t_fold = time.perf_counter() - t0

            lanes, paths, rows = [], [], []
            for i in range(M):
                for k in range(K):
                    if not writing[i, k]:
                        continue
                    produced[i] += 1
                    lanes.append(i * K + k)
                    paths.append(out_name(i, produced[i], streams[i].pdb_dir,
                                          ".pdb"))
                    rows.append((i, k, produced[i]))
            t0 = time.perf_counter()
            write_decoys(fr, lanes, paths)
            t_emit = time.perf_counter() - t0

            t0 = time.perf_counter()
            adv = np.zeros((C,), bool)
            adv[lanes] = True
            a = fr.atoms
            chains, delta = _chain_update_batch(
                chains, a["N"], a["CA"], a["C"], a["CB"],
                torch.as_tensor(adv, device=dev), cfg.sigma, cfg.angle)
            delta_np = host_numpy(delta)   # the step's other host reads:
            e_np = host_numpy(fr.energy)   # deltas and energies
            trace.write(kind="phase", step=max(produced),
                        t_fold=round(t_fold, 3), t_emit=round(t_emit, 3),
                        t_measure=round(time.perf_counter() - t0, 3),
                        **tm_fold, energy_evals=STATS.evals - counted[0],
                        host_syncs=STATS.syncs - counted[1])
            for (i, k, num) in rows:
                c = i * K + k
                if num < cfg.Nmax:
                    # as the sequential sampler, which stops at Nmax before
                    # saving: no trailing Nmax + 1 state
                    io.submit(save_hist_npz,
                              out_name(i, num + 1, streams[i].npz_dir,
                                       ".npz"), chains, c)
                trace.write(decoy=f"{pdb_name}{num}", kind="chain",
                            model=streams[i].tag, chain=k,
                            energy=float(e_np[c]), delta=float(delta_np[c]))
                if delta_np[c] < CONVERGE_TOL:
                    active[i, k] = False
    except Exception:
        io.close(raise_errors=False)  # keep the loop's error
        raise
    t0 = time.perf_counter()
    io.close()
    trace.write(kind="phase", step="io_drain",
                t_io=round(time.perf_counter() - t0, 3))

    # the provisional names, now that every stream's count is known
    for i in range(1, M):
        if begins[i] is None:
            begins[i] = begins[i - 1] + produced[i - 1]
    for path, i, k, ext in renames:
        final = os.path.join(os.path.dirname(path),
                             f"{pdb_name}{begins[i] + k}{ext}")
        if os.path.exists(path):
            os.replace(path, final)
    return [begins[i] + produced[i] for i in range(M)]


def _generate_ensemble_chains(pdb_name, processed_npz_dir, pred_pdb_dir,
                              initial_npz, seq, cfg: DynamicsConfig,
                              generator=None, begin_num: int = 0,
                              trace: Optional[TraceWriter] = None,
                              device="cuda") -> int:
    """The batched sampler for one model."""
    if isinstance(initial_npz, (str, os.PathLike)):
        with np.load(initial_npz) as f:
            initial_npz = dict(f)
    stream = _ModelStream(tag="", npz_dir=processed_npz_dir,
                          pdb_dir=pred_pdb_dir,
                          hist=histograms_from_npz(initial_npz, device),
                          begin=begin_num)
    return _generate_chains_multi(pdb_name, [stream], seq, cfg, generator,
                                  trace, device)[0]
