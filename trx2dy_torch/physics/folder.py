"""The restrained-minimization folder: npz histograms -> backbone decoys.

Port of the non-relax part of trx2dy/physics/folder.py (the reference's
PyRosetta pipeline, folding/folding.py:32-281). The whole decoy ensemble
minimises as one batch. Protocol, as the JAX package's staged driver runs
it with fastrelax=False:

  1. random Ramachandran-basin torsions, omega = 180 deg
     (utils_ros.py:656-696);
  2. clash removal: up to 5 rounds of vdw-only minimisation of the decoys
     whose vdw score is >= 10 (utils_ros.py:699-703);
  3. per restraint stage (mode 2: one, 1 <= |i-j| < L): 3 x L-BFGS on the
     centroid score function, one pass on the cartesian-flavour weights,
     then clash removal on scorefxn1 (folding.py:105,168-170).

Every stage runs in chunks of STAGE_CHUNK iterations; between chunks the
converged lanes of a large batch are parked and the active ones repacked
into a smaller bucket. The energy is the compacted pair-list path, whose
restraint splines run through the CUDA kernel's pair entry.

FastRelax, the cartesian refinement, the af2/idp/gpcr restraint modes and
chain folding come with later slices of the port. JAX's single-program
driver (staged_execution=False, _protocol_jit) is a compile strategy of
XLA; the port has one protocol driver.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from trx2dy_torch.device import resolve_device
from trx2dy_torch.geometry.nerf import build_backbone
from trx2dy_torch.physics.compact import compact_restraints, compact_to
from trx2dy_torch.physics.energy import (
    SCOREFXN1, SCOREFXN_CART, SCOREFXN_CENT, SCOREFXN_VDW,
    batched_energy_weighted_compact, weights_to_vec,
)
from trx2dy_torch.physics.minimize import (
    host_numpy, lbfgs_init, lbfgs_run, state_gather,
)
from trx2dy_torch.physics.restraints import (
    FoldParams, RestraintMasks, RestraintSet, add_disulfide_restraints,
    compile_restraints, disulfide_pairs, restraint_masks,
)

CLASH_SCORE_CUTOFF = 10.0   # remove_clash threshold (utils_ros.py:699-703)
CLASH_ROUNDS = 5

# Nonmonotone Armijo window of the restrained stages (0 = monotone; the
# JAX package's measured choice)
NONMONOTONE_WINDOW = 0

# L-BFGS iterations per chunk of a stage; converged lanes are repacked at
# chunk boundaries
STAGE_CHUNK = 250

# converged-lane repacking: once the active lanes fit in half the batch,
# repack them into the next power-of-2 bucket (at least COMPACT_MIN_BATCH),
# for batches of at least LANE_REPACK_MIN_BATCH decoys
COMPACT_MIN_BATCH = 8
LANE_REPACK_MIN_BATCH = 48

# Ramachandran basin table and probabilities (utils_ros.py:674-696)
_BASIN_PHI = np.deg2rad([-140.0, -72.0, -122.0, -82.0, -61.0, 57.0])
_BASIN_PSI = np.deg2rad([153.0, 145.0, 117.0, -14.0, -41.0, 39.0])
_BASIN_P = np.array([0.135, 0.155, 0.073, 0.122, 0.497, 0.018])


class FoldResult(NamedTuple):
    torsions: torch.Tensor   # (B, 3, L) final [phi; psi; omega]
    energy: torch.Tensor     # (B,) final centroid score
    atoms: dict              # atom -> (B, L, 3)


def random_torsions(generator: Optional[torch.Generator], L: int,
                    n_decoys: int, device="cpu") -> torch.Tensor:
    """(B, 3, L) basin-sampled (phi, psi) with omega = pi. Drawn on the CPU
    from `generator`, so a seed gives the same start on every device."""
    basin = torch.multinomial(torch.as_tensor(_BASIN_P), n_decoys * L,
                              replacement=True, generator=generator)
    basin = basin.reshape(n_decoys, L)
    phi = torch.as_tensor(_BASIN_PHI, dtype=torch.float32)[basin]
    psi = torch.as_tensor(_BASIN_PSI, dtype=torch.float32)[basin]
    omg = torch.full((n_decoys, L), np.pi, dtype=torch.float32)
    return torch.stack([phi, psi, omg], dim=1).to(device)


def pad_npz(npz: dict, L: int, pad_to: int) -> dict:
    """Zero-pad (L, L, ...) maps and (L,) masks to pad_to. Zero
    probabilities stay below every cutoff, so padding never activates a
    restraint."""
    out = {}
    p = pad_to - L
    for k, v in npz.items():
        v = np.asarray(v)
        if v.ndim >= 2 and v.shape[0] == L and v.shape[1] == L:
            v = np.pad(v, [(0, p), (0, p)] + [(0, 0)] * (v.ndim - 2))
        elif v.ndim == 1 and v.shape[0] == L:
            v = np.pad(v, (0, p))
        out[k] = v
    return out


def _stage_masks_centroid(rst: RestraintSet, seq: str, mode: int,
                          pcut: float, idr=None) -> Sequence[RestraintMasks]:
    """Cumulative per-stage restraint masks of the centroid phase: by
    sequence separation (modes 0-2, folding.py:125-162) or by order then
    disorder pairs (mode 3, folding.py:173-187; idr the (L, L) or (L,)
    disorder mask)."""
    L = len(seq)
    stages = []

    def accumulate(m):
        if stages:
            m = RestraintMasks(*(a | b for a, b in zip(stages[-1], m)))
        stages.append(m)

    if mode == 3:
        if idr is None:
            raise ValueError("mode 3 requires the npz 'idr' mask")
        idr = np.asarray(idr, bool)
        if idr.ndim == 1:
            idr = idr[:, None] | idr[None, :]
        base = restraint_masks(rst, seq, 0, L, pcut=pcut)
        for pair_mask in (~idr, idr):           # order, then disorder
            accumulate(RestraintMasks(*(m & pair_mask for m in base)))
        return stages
    ranges = {0: [(1, 12), (12, 24), (24, L)], 1: [(3, 24), (24, L)],
              2: [(1, L)]}.get(mode)
    if ranges is None:
        raise ValueError(f"mode {mode} not supported (0/1/2/3)")
    for s1, s2 in ranges:
        accumulate(restraint_masks(rst, seq, s1, s2, pcut=pcut))
    return stages


def _bucket_size(n: int) -> int:
    b = COMPACT_MIN_BATCH
    while b < n:
        b *= 2
    return b


def _protocol_staged(x0, stages, max_iter: int, dist_on_ca: bool = False,
                     res_mask=None, stage_log: Optional[list] = None):
    """The centroid protocol over chunked L-BFGS stages.

    stages: per-stage compacted pair lists on the device (compact_to).
    stage_log, if given, receives (label, iterations, wall_s) per stage."""
    dev = x0.device
    B = x0.shape[0]
    no_freeze = torch.zeros((B,), dtype=torch.bool, device=dev)

    def wvec(w):
        return torch.as_tensor(weights_to_vec(w), device=dev)

    w_vdw, w_cent, w_cart, w_sf1 = (wvec(w) for w in (
        SCOREFXN_VDW, SCOREFXN_CENT, SCOREFXN_CART, SCOREFXN1))

    def energy(cr, w):
        def fun(xx):
            return batched_energy_weighted_compact(xx, cr, w, dist_on_ca,
                                                   res_mask)
        return fun

    def stage(x, cr, w, freeze=no_freeze, iters=None, label="stage"):
        t_st = time.perf_counter()
        iters = max_iter if iters is None else iters
        fun = energy(cr, w)
        B0 = x.shape[0]
        st = lbfgs_init(fun, x, freeze=freeze, nonmonotone=NONMONOTONE_WINDOW)
        x_full = x.clone()                    # final params per original lane
        lane = torch.arange(B0, device=dev)   # current lane -> original index
        remaining = iters
        while remaining > 0:
            st = lbfgs_run(fun, st, min(STAGE_CHUNK, remaining))
            remaining -= STAGE_CHUNK
            done = host_numpy(st.done)
            if done.all():
                break
            if remaining > 0 and B0 >= LANE_REPACK_MIN_BATCH:
                n_act = int((~done).sum())
                bucket = _bucket_size(n_act)
                if bucket <= len(done) // 2:
                    # park finished lanes, repack the active ones
                    x_full[lane] = st.x
                    act = np.where(~done)[0]
                    pad = np.where(done)[0][:bucket - n_act]
                    sel = np.concatenate([act, pad])
                    st = state_gather(st, sel)
                    lane = lane[torch.as_tensor(sel, device=dev)]
        x_full[lane] = st.x
        if stage_log is not None:
            stage_log.append((label, st.k,
                              round(time.perf_counter() - t_st, 3)))
        return x_full

    def vdw_scores(x):
        # vdw-only scores through the shared stage energy (all non-vdw
        # weights 0), as one value-and-gradient evaluation, as in JAX
        return host_numpy(lbfgs_init(energy(stages[0], w_vdw), x,
                                     freeze=~no_freeze).f)

    def remove_clash(x, w_min, cr, iters, label):
        for _ in range(CLASH_ROUNDS):
            active = vdw_scores(x) >= CLASH_SCORE_CUTOFF
            if not active.any():
                break
            x = stage(x, cr, w_min,
                      freeze=~torch.as_tensor(active, device=dev),
                      iters=iters, label=label)
        return x

    x = remove_clash(x0, w_vdw, stages[0], 500, "clash0")
    for cr in stages:
        for _ in range(3):                      # RepeatMover(min_mover, 3)
            x = stage(x, cr, w_cent, label="cent")
        x = stage(x, cr, w_cart, label="cart")
        x = remove_clash(x, w_sf1, cr, max_iter, "clash")
    f = lbfgs_init(energy(stages[-1], w_cent), x, freeze=~no_freeze).f
    return x, f


def fold_ensemble(npz: dict, seq: str,
                  generator: Optional[torch.Generator] = None,
                  n_decoys: int = 1, mode: int = 2, use_orient: bool = True,
                  fastrelax: bool = True, pcut: Optional[float] = None,
                  params: FoldParams = FoldParams(), max_iter: int = 1000,
                  x0=None, rst_mode: str = "no-idp",
                  staged_execution: bool = True, oversample: float = 0.0,
                  pad_to: Optional[int] = None, detect_disulf: bool = True,
                  device="cuda",
                  stage_log: Optional[list] = None) -> FoldResult:
    """Fold an ensemble of decoys from predicted geometry histograms.

    npz: 'dist' (+ 'omega'/'theta'/'phi' with use_orient); seq: one-letter
    sequence; generator: seeds the torsion init (x0 None); x0: optional
    (B, 3, L) or (B, 3L) start torsions; oversample: fold
    ceil(n_decoys (1 + oversample)) decoys and keep the n_decoys of lowest
    energy; pad_to: pad to this length with inert residues. Returns
    torsions, final centroid energies and atoms, all on `device`.
    fastrelax=True and rst_mode other than "no-idp" raise
    NotImplementedError until a later slice of the port."""
    if fastrelax:
        raise NotImplementedError(
            "fastrelax is not ported yet (slice 3 of the PyTorch port): "
            "fold with fastrelax=False (CLI: --no-fastrelax)")
    if rst_mode != "no-idp":
        raise NotImplementedError(
            f"rst_mode {rst_mode!r} is not ported yet (slice 3 of the "
            "PyTorch port); use 'no-idp'")
    if not staged_execution:
        raise NotImplementedError(
            "staged_execution=False selects the JAX package's single-program "
            "compile strategy; the PyTorch port has one protocol driver")
    dev = resolve_device(device)
    L = len(seq)
    if np.asarray(npz["dist"]).shape[0] != L:
        raise ValueError(
            f"sequence length {L} does not match npz geometry maps "
            f"{np.asarray(npz['dist']).shape[:2]}")
    L_true = L
    res_mask = None
    if pad_to is not None and pad_to > L:
        npz = pad_npz(npz, L, pad_to)
        seq = seq + "A" * (pad_to - L)
        res_mask = torch.arange(pad_to, device=dev) < L
        L = pad_to
    pcut = params.PCUT if pcut is None else pcut
    rst = compile_restraints(npz, params, use_orient=use_orient)
    if detect_disulf:
        ss = disulfide_pairs(npz["dist"], seq)
        if len(ss):
            rst = add_disulfide_restraints(rst, ss)
    stages = [compact_to(compact_restraints(rst, m), L, dev)
              for m in _stage_masks_centroid(rst, seq, mode, pcut,
                                             idr=npz.get("idr"))]

    n_fold = n_decoys
    if x0 is None:
        if oversample > 0.0:
            n_fold = int(np.ceil(n_decoys * (1.0 + oversample)))
        x0 = random_torsions(generator, L, n_fold)
    x0 = torch.as_tensor(np.asarray(x0) if not torch.is_tensor(x0) else x0,
                         dtype=torch.float32).to(dev)
    x0 = x0.reshape(x0.shape[0], 3 * L)

    x, f = _protocol_staged(x0, stages, max_iter, res_mask=res_mask,
                            stage_log=stage_log)
    if n_fold > n_decoys:
        keep = torch.argsort(f)[:n_decoys]
        x, f = x[keep], f[keep]

    t = x.reshape(-1, 3, L)
    atoms = build_backbone(t[:, 0], t[:, 1], t[:, 2])
    if L_true < L:
        atoms = {k: v[:, :L_true] for k, v in atoms.items()}
    return FoldResult(torsions=t[:, :, :L_true], energy=f, atoms=atoms)
