"""The restrained-minimization folder: npz histograms -> decoys.

Port of trx2dy/physics/folder.py (the reference's PyRosetta pipeline,
folding/folding.py:32-281). The whole decoy ensemble minimises as one
batch. Protocol, as the JAX package's staged driver runs it:

  1. random Ramachandran-basin torsions, omega = 180 deg
     (utils_ros.py:656-696);
  2. clash removal: up to 5 rounds of vdw-only minimisation of the decoys
     whose vdw score is >= 10 (utils_ros.py:699-703);
  3. per restraint stage (mode 2: one, 1 <= |i-j| < L): 3 x L-BFGS on the
     centroid score function, one pass on the cartesian-flavour weights,
     then clash removal on scorefxn1 (folding.py:105,168-170);
  4. with fastrelax (the default), the FastRelax substitute
     (folding.py:189-268): relax round 1 on the pcut 0.15 restraints, the
     round-1 cartesian block (per-atom displacements, cartmin.py) projected
     back to torsions, relax round 2 on the pcut 0.30 restraints; each
     round ramps the repulsive and restraint weights over its schedule,
     RELAX_REPEATS times, keeping the best full-weight pose per repeat
     (accept_to_best); glycine pairs are excluded (nogly);
  5. after energy gating (oversample), the cartesian refinement of the
     kept decoys against the pcut 0.30 restraints (cart_refine).

Step 4's cartesian block and step 5 run for the no-idp and idp restraint
modes, as in JAX. Every stage runs in chunks of STAGE_CHUNK iterations;
between chunks the converged lanes of a large batch are parked and the
active ones repacked into a smaller bucket. The energy is the compacted
pair-list path, whose restraint splines run through the CUDA kernel's pair
entry, one launch per energy evaluation, in every stage above.

fold_chains_pool is the Dynamics sampler's fold: one decoy per chain,
each chain with its own restraint tables, built on the device from the
sampler's histograms (physics/tablegen.py) over one shared pair list per
term (compact.UnionStage); its energy evaluations launch the kernel's
lanes entry once each. fold_chains, the public chain fold, takes one npz
dict per chain: it compiles each distinct dict's restraints on the host,
as fold_ensemble does, and builds every protocol stage as the same union
form (compact.compact_restraints_lanes), so its evaluations launch the
lanes entry once each too. The in-loop repacking switch (REPACK_IN_LOOP,
off in JAX) is not ported. JAX's single-program driver
(staged_execution=False, _protocol_jit) is a compile strategy of XLA; the
port has one protocol driver.
"""
from __future__ import annotations

import hashlib
import time
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from trx2dy_torch.device import resolve_device
from trx2dy_torch.geometry.nerf import build_backbone
from trx2dy_torch.geometry.transforms import backbone_torsions, dihedral
from trx2dy_torch.physics.cartmin import (
    cartesian_refine_compact, cartesian_refine_lanes, cartesian_relax_block,
)
from trx2dy_torch.physics.compact import (
    UnionStage, _bucket as _pair_bucket, compact_restraints,
    compact_restraints_lanes, compact_to, union_stage, union_take_lanes,
)
from trx2dy_torch.physics.energy import (
    SCOREFXN1, SCOREFXN_CART, SCOREFXN_CENT, SCOREFXN_VDW, EnergyWeights,
    batched_energy_weighted_compact, batched_energy_weighted_union,
    weights_to_vec,
)
from trx2dy_torch.physics.minimize import (
    host_numpy, host_sync, lbfgs_init, lbfgs_run, state_gather,
)
from trx2dy_torch.physics.restraints import (
    FoldParams, RestraintMasks, RestraintSet, add_disulfide_restraints,
    compile_restraints, compile_restraints_af2, compile_restraints_gpcr,
    compile_restraints_idp, disulfide_pairs, restraint_masks,
)

# FastRelax's score function: ref2015_cart with constraint weights 5/1/1
# (folding.py:200-204); the torsion-space substitute keeps the centroid
# terms
SCOREFXN_RELAX = EnergyWeights(hbond_sr=3.0, hbond_lr=3.0, rama=1.0,
                               omega=0.5, vdw=0.5,
                               atom_pair=5.0, dihedral=1.0, angle=1.0)

# FastRelax ramp schedules (data/1relax_round1.txt, 2relax_round2.txt):
# each (fa_rep_scale, cst_scale, iterations) stage scales the repulsive
# term and every restraint term, then minimises. Round 1's
# `switch:cartesian repeat 1` block (1relax_round1.txt:10-16) is
# CART_SCHEDULE_R1, run in atom space between the two rounds; round 2's
# cartesian channel is the final cartesian refinement.
RELAX_SCHEDULE_R1 = ((0.02, 1.0, 100), (0.25, 0.5, 100),
                     (0.55, 0.1, 100), (1.0, 0.1, 100))
RELAX_SCHEDULE_R2 = ((0.02, 1.0, 50), (0.25, 0.5, 50),
                     (0.55, 0.1, 100), (1.0, 0.1, 200))
CART_SCHEDULE_R1 = ((0.02, 1.0, 50), (0.25, 0.5, 50),
                    (0.55, 0.1, 100), (1.0, 0.1, 200))
RELAX_REPEATS = 2
CART_REFINE_ITERS = 200     # the final cartesian refinement's budget

CLASH_SCORE_CUTOFF = 10.0   # remove_clash threshold (utils_ros.py:699-703)
CLASH_ROUNDS = 5

# Nonmonotone Armijo window of the restrained stages (0 = monotone; the
# JAX package's measured choice)
NONMONOTONE_WINDOW = 0

# L-BFGS iterations per chunk of a stage; converged lanes are repacked at
# chunk boundaries
STAGE_CHUNK = 250

# pair-list margin of fold_chains_pool on top of the dampening-proxy
# count (tablegen count row 1): the proxy models one dampening step, later
# steps drift ~1 % further (measured in JAX), so the chain steps keep one
# set of shapes; the bucket_floors ratchet stays as the backstop
GROWTH_HEADROOM = 1.08

# converged-lane repacking: once the active lanes fit in half the batch,
# repack them into the next power-of-2 bucket (at least COMPACT_MIN_BATCH),
# for batches of at least LANE_REPACK_MIN_BATCH decoys
COMPACT_MIN_BATCH = 8
LANE_REPACK_MIN_BATCH = 48

# Ramachandran basin table and probabilities (utils_ros.py:674-696)
_BASIN_PHI = np.deg2rad([-140.0, -72.0, -122.0, -82.0, -61.0, 57.0])
_BASIN_PSI = np.deg2rad([153.0, 145.0, 117.0, -14.0, -41.0, 39.0])
_BASIN_P = np.array([0.135, 0.155, 0.073, 0.122, 0.497, 0.018])


def _ramped_relax_weights(fa_scale: float, cst_scale: float) -> EnergyWeights:
    w = SCOREFXN_RELAX
    return w._replace(vdw=w.vdw * fa_scale, atom_pair=w.atom_pair * cst_scale,
                      dihedral=w.dihedral * cst_scale,
                      angle=w.angle * cst_scale)


def _cart_r1_stages():
    """CART_SCHEDULE_R1 as ((w_vec, iters), ...) for the cartesian block."""
    return tuple((weights_to_vec(_ramped_relax_weights(fa, cst)), iters)
                 for fa, cst, iters in CART_SCHEDULE_R1)


def _project_torsions(x, atoms):
    """(B, 3L) torsions re-extracted from (cartesian-displaced) atoms.

    The projection back onto the NeRF manifold before relax round 2: the
    slots build_backbone does not use keep their incoming values (phi[0],
    omega[-1]), and psi[-1] comes from the carbonyl O, which NeRF places
    anti to the next N at torsion psi + pi about N-CA-C."""
    B = x.shape[0]
    t0 = x.reshape(B, 3, -1)
    n, ca, c, o = (atoms[k] for k in ("N", "CA", "C", "O"))
    (phi, psi, omg), _ = backbone_torsions(n, ca, c)
    psi_last = dihedral(n[:, -1], ca[:, -1], c[:, -1], o[:, -1]) - np.pi
    phi = torch.cat([t0[:, 0, :1], phi[:, 1:]], dim=-1)
    psi = torch.cat([psi[:, :-1], psi_last[:, None]], dim=-1)
    omg = torch.cat([omg[:, :-1], t0[:, 2, -1:]], dim=-1)
    return torch.stack([phi, psi, omg], dim=1).reshape(B, -1)


class FoldResult(NamedTuple):
    """Result of a fold. `atoms` is authoritative: after the cartesian
    refinement (fastrelax and cart_refine) it holds the refined
    coordinates, off the ideal NeRF manifold, while `torsions` and `energy`
    are the minimiser's state and centroid score from before it. Pack
    sidechains onto `atoms` (sidechain.pack_ensemble(backbone=...))."""
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
                     res_mask=None, stage_log: Optional[list] = None,
                     relax=None, cart_r1: bool = False):
    """The protocol over chunked L-BFGS stages: centroid stages, then with
    relax = (relax1, relax2) the two FastRelax rounds, with the round-1
    cartesian block between them when cart_r1.

    stages, relax1, relax2: compacted pair lists on the device
    (compact_to), each built once per fold, or the sampler's union stages
    (compact.union_stage, per-lane tables; converged-lane repacking then
    gathers the surviving lanes' table rows and activity too). stage_log, if
    given, receives (label, iterations, wall_s) per stage. Returns (x,
    final centroid energies)."""
    dev = x0.device
    B = x0.shape[0]
    no_freeze = torch.zeros((B,), dtype=torch.bool, device=dev)

    def wvec(w):
        return torch.as_tensor(weights_to_vec(w), device=dev)

    w_vdw, w_cent, w_cart, w_sf1 = (wvec(w) for w in (
        SCOREFXN_VDW, SCOREFXN_CENT, SCOREFXN_CART, SCOREFXN1))

    def energy(cr, w):
        if isinstance(cr, UnionStage):
            def fun(xx):
                return batched_energy_weighted_union(xx, cr, w, dist_on_ca,
                                                     res_mask)
        else:
            def fun(xx):
                return batched_energy_weighted_compact(xx, cr, w,
                                                       dist_on_ca, res_mask)
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
                    if isinstance(cr, UnionStage):
                        # the lane -> table row map and the activity
                        # follow their lanes, on the device
                        cr = union_stage(*union_take_lanes(cr.ur, cr.acts,
                                                           sel))
                        fun = energy(cr, w)
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

    if relax is not None:
        relax1, relax2 = relax
        w_relax = wvec(SCOREFXN_RELAX)

        def full_f(xx, cr):
            # full-weight relax score, one value-and-gradient evaluation
            return lbfgs_init(energy(cr, w_relax), xx, freeze=~no_freeze).f

        def relax_round(x, cr, schedule, label):
            best_x, best_f = x, full_f(x, cr)
            for _ in range(RELAX_REPEATS):
                for fa, cst, iters in schedule:
                    x = stage(x, cr, wvec(_ramped_relax_weights(fa, cst)),
                              iters=iters, label=label)
                # accept_to_best, on the device: no host sync
                f = full_f(x, cr)
                best_x = torch.where((f < best_f)[:, None], x, best_x)
                best_f = torch.minimum(f, best_f)
            return best_x

        x = relax_round(x, relax1, RELAX_SCHEDULE_R1, "relax1")
        if cart_r1:
            # round 1's cartesian repeat on the same pcut 0.15 tables,
            # projected back to torsions before round 2's restraint set
            t = x.reshape(B, 3, -1)
            with torch.no_grad():
                atoms = build_backbone(t[:, 0], t[:, 1], t[:, 2])
            atoms, _ = cartesian_relax_block(
                atoms, relax1, _cart_r1_stages(),
                weights_to_vec(SCOREFXN_RELAX), dist_on_ca=dist_on_ca,
                res_mask=res_mask, stage_log=stage_log)
            x = _project_torsions(x, atoms)
        x = relax_round(x, relax2, RELAX_SCHEDULE_R2, "relax2")
    f = lbfgs_init(energy(stages[-1], w_cent), x, freeze=~no_freeze).f
    return x, f


def fold_ensemble(npz: dict, seq: str,
                  generator: Optional[torch.Generator] = None,
                  n_decoys: int = 1, mode: int = 2, use_orient: bool = True,
                  fastrelax: bool = True, pcut: Optional[float] = None,
                  params: FoldParams = FoldParams(), max_iter: int = 1000,
                  x0=None, rst_mode: str = "no-idp",
                  known_npz: Optional[dict] = None,
                  staged_execution: bool = True, oversample: float = 0.0,
                  pad_to: Optional[int] = None, detect_disulf: bool = True,
                  cart_refine: bool = True, device="cuda",
                  stage_log: Optional[list] = None) -> FoldResult:
    """Fold an ensemble of decoys from predicted geometry histograms.

    npz: 'dist' (+ 'omega'/'theta'/'phi' with use_orient; 'idr' for the
    idp and gpcr modes and mode 3; 'bins' for af2); seq: one-letter
    sequence; generator: seeds the torsion init (x0 None); x0: optional
    (B, 3, L) or (B, 3L) start torsions; rst_mode: no-idp, af2 (CA-CA
    distograms, no orientation), idp or gpcr (with known_npz, the known
    structures' geometry maps); oversample: fold
    ceil(n_decoys (1 + oversample)) decoys and keep the n_decoys of lowest
    energy; pad_to: pad to this length with inert residues; cart_refine:
    with fastrelax, the round-1 cartesian block and the final cartesian
    refinement (no-idp and idp). Returns torsions, final centroid energies
    and atoms, all on `device` (see FoldResult)."""
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
        if known_npz is not None:
            # known_npz holds real-valued (N, L, L) maps, not histograms:
            # zero padding would bin fake 0-distance contacts
            raise ValueError(
                "pad_to (length bucketing) is not supported together with "
                "known_npz / rst_mode='gpcr'; fold this target unbucketed")
        npz = pad_npz(npz, L, pad_to)
        seq = seq + "A" * (pad_to - L)
        res_mask = torch.arange(pad_to, device=dev) < L
        L = pad_to
    pcut = params.PCUT if pcut is None else pcut
    dist_on_ca = rst_mode == "af2"
    if rst_mode == "no-idp":
        rst = compile_restraints(npz, params, use_orient=use_orient)
    elif rst_mode == "af2":
        if use_orient:
            raise ValueError("af2 restraints do not support --orient "
                             "(utils_ros.py:150)")
        rst = compile_restraints_af2(npz, params)
    elif rst_mode == "idp":
        rst = compile_restraints_idp(npz, params, use_orient=use_orient)
    elif rst_mode == "gpcr":
        if known_npz is None:
            raise ValueError("rst_mode='gpcr' requires known_npz "
                             "(folding CLI -KNOWN)")
        rst = compile_restraints_gpcr(npz, known_npz, params,
                                      use_orient=use_orient)
    else:
        raise ValueError(f"unknown rst_mode {rst_mode!r}")
    if detect_disulf and rst_mode in ("no-idp", "idp"):
        ss = disulfide_pairs(npz["dist"], seq)
        if len(ss):
            rst = add_disulfide_restraints(rst, ss)

    def device_pairs(masks):
        return compact_to(compact_restraints(rst, masks), L, dev)

    stages = [device_pairs(m)
              for m in _stage_masks_centroid(rst, seq, mode, pcut,
                                             idr=npz.get("idr"))]
    relax = None
    if fastrelax:
        relax = tuple(device_pairs(restraint_masks(rst, seq, 1, L, pcut=pc,
                                                   nogly=True))
                      for pc in (0.15, 0.30))
    cart = cart_refine and fastrelax and rst_mode in ("no-idp", "idp")

    n_fold = n_decoys
    if x0 is None:
        if oversample > 0.0:
            n_fold = int(np.ceil(n_decoys * (1.0 + oversample)))
        x0 = random_torsions(generator, L, n_fold)
    x0 = torch.as_tensor(np.asarray(x0) if not torch.is_tensor(x0) else x0,
                         dtype=torch.float32).to(dev)
    x0 = x0.reshape(x0.shape[0], 3 * L)

    x, f = _protocol_staged(x0, stages, max_iter, dist_on_ca=dist_on_ca,
                            res_mask=res_mask, stage_log=stage_log,
                            relax=relax, cart_r1=cart)
    if n_fold > n_decoys:
        keep = torch.argsort(f)[:n_decoys]
        x, f = x[keep], f[keep]

    t = x.reshape(-1, 3, L)
    with torch.no_grad():
        atoms = build_backbone(t[:, 0], t[:, 1], t[:, 2])
    if cart:
        # the reference's cartesian channel (folding.py:169,234) on the
        # kept lanes, against the pcut 0.30 tables of relax round 2
        atoms, _ = cartesian_refine_compact(
            atoms, relax[1], SCOREFXN_RELAX, max_iter=CART_REFINE_ITERS,
            res_mask=res_mask, stage_log=stage_log)
    if L_true < L:
        atoms = {k: v[:, :L_true] for k, v in atoms.items()}
    return FoldResult(torsions=t[:, :, :L_true], energy=f, atoms=atoms)


def _chain_starts(x0, generator, L: int, C: int, dev) -> torch.Tensor:
    """(C, 3L) start torsions of a chain fold on dev: x0 (C' <= C, 3, L)
    with its last row repeated, or basin samples drawn from generator."""
    if x0 is None:
        x0 = random_torsions(generator, L, C)
    x0 = torch.as_tensor(np.asarray(x0) if not torch.is_tensor(x0) else x0,
                         dtype=torch.float32).to(dev)
    if x0.shape[0] < C:
        x0 = torch.cat([x0, x0[-1:].expand((C - x0.shape[0],)
                                           + x0.shape[1:])])
    return x0.reshape(C, 3 * L)


def _pick_candidates(f, K: int, reps: int, n_real: int) -> torch.Tensor:
    """Lane of each of K chains: of its reps candidate lanes (k * reps ..
    k * reps + reps - 1) the one of lowest final energy f."""
    if reps > 1:
        f_np = host_numpy(f)[:n_real].reshape(K, reps)
        pick = np.arange(K) * reps + np.argmin(f_np, axis=1)
    else:
        pick = np.arange(K)
    return torch.as_tensor(pick, device=f.device)


def fold_chains_pool(pool: dict, lane_map, seq: str,
                     generator: Optional[torch.Generator] = None,
                     mode: int = 2, use_orient: bool = True,
                     fastrelax: bool = True, pcut: Optional[float] = None,
                     params: FoldParams = FoldParams(),
                     max_iter: int = 1000, candidates: int = 1,
                     detect_disulf: bool = True,
                     bucket_floors: Optional[dict] = None,
                     cart_refine: bool = True,
                     lane_bucket: Optional[int] = None, res_mask=None,
                     true_len: Optional[int] = None, x0=None,
                     timings: Optional[dict] = None,
                     stage_log: Optional[list] = None,
                     growth_buckets: bool = False) -> FoldResult:
    """One decoy per chain from a pool of histograms on the device, the
    Dynamics sampler's fold (folder.py:888-1010). The restraint tables are
    built on the pool's device by physics/tablegen.py: one shared union
    pair list per term with per-lane tables (compact.UnionStage).

    pool: 'dist'/'omega'/'theta'/'phi' lane-stacked (U, L, L, nbins)
    tensors, already padded where length bucketing is used (pass res_mask
    and true_len then). lane_map: (K,) chain k folds from pool row
    lane_map[k]. candidates: lanes folded per chain, the lowest final
    energy kept. lane_bucket: pad the folded lanes to this count by
    repeating the last. bucket_floors: caller-owned {"all": {term: P}},
    ratcheted so later calls keep the pair-list sizes. growth_buckets: size
    the pair lists from the dampening-proxy counts (the driver's chain
    steps) rather than the counts as given (its initial fold). timings, if
    given, receives the wall seconds of the counts, the tables, the
    protocol and the cartesian refinement. generator seeds the torsion
    init (x0 None); x0 (C' <= C, 3, L) start torsions, the last repeated.

    The host reads the 4 counts, the energies for the candidate pick and
    what the caller reads of the decoys. Mode 3, idp and gpcr targets are
    not compiled on the device; the JAX package sends them to the host
    chain fold (fold_chains)."""
    from trx2dy_torch.physics.tablegen import NAMES, union_compiler

    dev = pool["dist"].device
    L = len(seq)
    lane_map = np.asarray(lane_map, np.int64)
    K = len(lane_map)
    reps = candidates if candidates > 1 else 1
    fan = np.repeat(lane_map, reps)
    n_real = len(fan)
    if lane_bucket is not None and lane_bucket > n_real:
        fan = np.concatenate([fan, np.full(lane_bucket - n_real, fan[-1])])
    C = len(fan)

    tm = {} if timings is None else timings
    t0 = time.perf_counter()
    comp = union_compiler(seq, params, mode, pcut, use_orient,
                          detect_disulf, dev)
    count_rows = host_numpy(comp.count(pool))
    counts = count_rows[1] if growth_buckets else count_rows[0]
    tm["t_counts"] = round(time.perf_counter() - t0, 3)
    fl = (bucket_floors.setdefault("all", {})
          if bucket_floors is not None else {})
    P = tuple(
        max(_pair_bucket(int(np.ceil(c * (1.0 if n in fl else
                                          GROWTH_HEADROOM)))),
            fl.get(n, 0))
        for n, c in zip(NAMES, counts))
    for n, p_t in zip(NAMES, P):
        fl[n] = max(fl.get(n, 0), p_t)

    t0 = time.perf_counter()
    ur, stage_acts, r1_acts, r2_acts = comp.compile(pool, fan, P)
    # each protocol stage's tables checked once for this step
    stages = [union_stage(ur, a) for a in stage_acts]
    relax = (union_stage(ur, r1_acts), union_stage(ur, r2_acts)) \
        if fastrelax else None
    host_sync(dev)
    tm["t_tables"] = round(time.perf_counter() - t0, 3)

    x0 = _chain_starts(x0, generator, L, C, dev)

    t0 = time.perf_counter()
    x, f = _protocol_staged(x0, stages, max_iter, res_mask=res_mask,
                            stage_log=stage_log, relax=relax,
                            cart_r1=cart_refine and fastrelax)
    host_sync(dev)
    tm["t_protocol"] = round(time.perf_counter() - t0, 3)
    t_all = x.reshape(C, 3, L)
    with torch.no_grad():
        atoms = build_backbone(t_all[:, 0], t_all[:, 1], t_all[:, 2])
    if cart_refine and fastrelax:
        # over every bucketed lane, before the candidate pick, each lane
        # against its own relax round-2 tables
        t0 = time.perf_counter()
        atoms, _ = cartesian_refine_lanes(
            atoms, relax[1], SCOREFXN_RELAX, max_iter=CART_REFINE_ITERS,
            res_mask=res_mask, stage_log=stage_log)
        host_sync(dev)
        tm["t_cart"] = round(time.perf_counter() - t0, 3)
    pick = _pick_candidates(f, K, reps, n_real)
    L_true = L if true_len is None else true_len
    return FoldResult(torsions=t_all[pick][:, :, :L_true], energy=f[pick],
                      atoms={k: v[pick][:, :L_true]
                             for k, v in atoms.items()})


def _npz_fingerprint(npz: dict) -> str:
    """Content hash of a histogram dict (keys, shapes, dtypes, bytes), the
    key by which fold_chains compiles each distinct dict once."""
    h = hashlib.blake2b(digest_size=16)
    for k in sorted(npz):
        a = np.asarray(npz[k])
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def fold_chains(npz_list, seq: str,
                generator: Optional[torch.Generator] = None, mode: int = 2,
                use_orient: bool = True, fastrelax: bool = True,
                pcut: Optional[float] = None,
                params: FoldParams = FoldParams(), max_iter: int = 1000,
                x0=None, candidates: int = 1, detect_disulf: bool = True,
                bucket_floors: Optional[dict] = None,
                cart_refine: bool = True, pad_to: Optional[int] = None,
                lane_bucket: Optional[int] = None, device="cuda",
                stage_log: Optional[list] = None) -> FoldResult:
    """One decoy per chain, each chain with its own restraint set
    (folder.py:1028-1190): npz_list holds one histogram dict per chain.

    Dicts of equal content (_npz_fingerprint) compile their restraints
    once. candidates > 1 folds that many lanes per chain from fresh starts
    and keeps the one of lowest final energy (not with x0). lane_bucket
    pads the folded lanes to that count by repeating the last. pad_to pads
    the target to that length with inert residues (masked out of every
    term). bucket_floors: caller-owned {"all": {term: P}}, ratcheted so
    later calls keep the pair-list sizes. generator seeds the torsion init
    (x0 None); x0 (C' <= C, 3, L) start torsions, the last repeated.
    Mode 3 raises, as in JAX: the stage masks are built without the npz
    'idr' mask. With fastrelax and cart_refine, every bucketed lane is
    refined in cartesian space before the pick. stage_log, if given,
    receives (label, iterations, wall_s) per stage. Returns torsions,
    final centroid energies and atoms on `device`."""
    dev = resolve_device(device)
    L_true = L = len(seq)
    K = len(npz_list)
    if candidates > 1 and x0 is not None:
        raise ValueError(
            "candidates > 1 requires x0=None: candidate lanes are fresh "
            "random inits per chain; explicit torsions would fold the same "
            "start candidate times with no best-of selection")
    pcut = params.PCUT if pcut is None else pcut
    # compile once per distinct content, hashed before padding (which
    # copies); the id() memo spares re-hashing a dict passed many times
    uniq: dict = {}
    lane_of = []
    fp_memo: dict = {}
    for npz in npz_list:
        fp = fp_memo.get(id(npz))
        if fp is None:
            fp = fp_memo[id(npz)] = _npz_fingerprint(npz)
        if fp not in uniq:
            uniq[fp] = (len(uniq), npz)
        lane_of.append(uniq[fp][0])
    u_npzs = [npz for _, npz in uniq.values()]
    res_mask = None
    if pad_to is not None and pad_to > L:
        u_npzs = [pad_npz(npz, L, pad_to) for npz in u_npzs]
        seq = seq + "A" * (pad_to - L)
        res_mask = torch.arange(pad_to, device=dev) < L
        L = pad_to
    u_rsts = [compile_restraints(npz, params, use_orient=use_orient)
              for npz in u_npzs]
    if detect_disulf:
        for idx, npz in enumerate(u_npzs):
            ss = disulfide_pairs(np.asarray(npz["dist"]), seq)
            if len(ss):
                u_rsts[idx] = add_disulfide_restraints(u_rsts[idx], ss)
    u_stages = [_stage_masks_centroid(r, seq, mode, pcut) for r in u_rsts]
    reps = candidates if candidates > 1 else 1
    fan = [u for u in lane_of for _ in range(reps)]
    n_real = len(fan)
    if lane_bucket is not None and lane_bucket > n_real:
        fan = fan + [fan[-1]] * (lane_bucket - n_real)
    C = len(fan)
    rsts = [u_rsts[u] for u in fan]

    def lanes(u_masks):
        # one floor for every stage, as in JAX: the stages share shapes
        fl = None if bucket_floors is None else \
            bucket_floors.setdefault("all", {})
        stage = compact_restraints_lanes(rsts, [u_masks[u] for u in fan],
                                         floor=fl, device=dev)
        if fl is not None:
            for name, t in zip(("dist", "omega", "theta", "phi"), stage.ur):
                fl[name] = max(fl.get(name, 0), t.tab.shape[0])
        return stage

    stages = [lanes([sm[s] for sm in u_stages])
              for s in range(len(u_stages[0]))]
    relax = tuple(lanes([restraint_masks(r, seq, 1, L, pcut=pc, nogly=True)
                         for r in u_rsts])
                  for pc in (0.15, 0.30)) if fastrelax else None

    x0 = _chain_starts(x0, generator, L, C, dev)

    cart = cart_refine and fastrelax
    x, f = _protocol_staged(x0, stages, max_iter, res_mask=res_mask,
                            stage_log=stage_log, relax=relax, cart_r1=cart)
    t_all = x.reshape(C, 3, L)
    with torch.no_grad():
        atoms = build_backbone(t_all[:, 0], t_all[:, 1], t_all[:, 2])
    if cart:
        # over every bucketed lane, before the candidate pick, each lane
        # against its own relax round-2 tables
        atoms, _ = cartesian_refine_lanes(
            atoms, relax[1], SCOREFXN_RELAX, max_iter=CART_REFINE_ITERS,
            res_mask=res_mask, stage_log=stage_log)
    pick = _pick_candidates(f, K, reps, n_real)
    return FoldResult(torsions=t_all[pick][:, :, :L_true], energy=f[pick],
                      atoms={k: v[pick][:, :L_true]
                             for k, v in atoms.items()})
