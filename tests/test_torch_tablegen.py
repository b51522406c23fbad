"""The sampler's device table compiler (trx2dy_torch/physics/tablegen.py),
the union energies and the per-lane spline entry against the JAX package,
on the CPU.

The inputs are tests/test_tablegen.py's: `_rand_npz` histograms from
numpy seeds at the same sequences, lengths and bucket sizes, so the JAX
programs are the ones that test compiles. The port stores a term's tables
once per used pool row as pair-major interval tables (P, U', K-1, 4) with a
(C,) lane -> row map, and the activity per lane as (P, C); JAX holds
per-lane tables lane-major, (C, P, K) and (C, P): the comparisons expand
the port's tables with the map and transpose. Counts, pair lists and
activity are compared exactly; tables y within 1e-5 of their largest
value, m within 1e-5 of the float32 scale of its product (float32). The union energies
are held on JAX's own tables (so only the energy differs): values in
float32 within 1e-5, gradients in float64 within 1e-8 (as
tests/test_torch_energy.py holds the batched energies).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from trx2dy.physics import cartmin as jcartmin
from trx2dy.physics import compact as jcompact
from trx2dy.physics import energy as jenergy
from trx2dy.physics import spline as jspline
from trx2dy.physics import tablegen as jtablegen
from trx2dy.physics.restraints import FoldParams as JFoldParams
from trx2dy_torch.ops import spline_energy as tops
from trx2dy_torch.physics import cartmin as tcartmin
from trx2dy_torch.physics import compact as tcompact
from trx2dy_torch.physics import energy as tenergy
from trx2dy_torch.physics import spline as tspline
from trx2dy_torch.physics import tablegen as ttablegen

torch.set_num_threads(2)

NAMES = ("dist", "omega", "theta", "phi")
TABLE_TOL = 1e-5      # y: relative to the term's largest |y|; m: relative
#                       to |y| @ |op|, the scale its float32 sum rounds at
VALUE_TOL = 1e-5      # union energies, float32, relative
GRAD_TOL = 1e-8       # their gradients, float64, relative to the largest


def _rand_npz(L, key=0, cys_pair=None):
    """tests/test_tablegen.py:_rand_npz."""
    rng = np.random.default_rng(key)

    def soft(shape):
        x = rng.random(shape).astype(np.float32)
        return x / x.sum(-1, keepdims=True)

    d = {"dist": soft((L, L, 37)), "omega": soft((L, L, 25)),
         "theta": soft((L, L, 25)), "phi": soft((L, L, 13))}
    if cys_pair is not None:
        i, j = cys_pair
        h = np.full(37, 1e-4, np.float32)
        h[4] = 0.9
        h /= h.sum()
        d["dist"][i, j] = d["dist"][j, i] = h
    return d


# name -> (sequence, npz list, mode, detect_disulf): tests/test_tablegen.py's
CASES = {
    "plain": ("ARNDCQEGHILKMF", lambda: [_rand_npz(14, key=41)], 2, False),
    "disulfide": ("ACNDCQEGHILKMF",
                  lambda: [_rand_npz(14, key=41, cys_pair=(1, 4))], 2, True),
    "three_lanes": ("ARNDCQEGHILKMFPS",
                    lambda: [_rand_npz(16, key=50 + k) for k in range(3)], 2,
                    False),
    "mode0": (("ARNDCQEGHILKMFPSTWYV" * 2)[:30],
              lambda: [_rand_npz(30, key=60)], 0, False),
}


def _compile_both(case, use_orient=True, lanes_per_row=2, lane_map=None):
    """Both packages' (count rows, compiled tables) of a case, at the
    as-given counts' buckets, each pool row fanned out to lanes_per_row
    lanes (or the lanes of lane_map)."""
    seq, npzs, mode, ss = CASES[case]
    npzs = npzs()
    jc = jtablegen.union_compiler(seq, JFoldParams(), mode, None, use_orient,
                                  ss)
    tc = ttablegen.union_compiler(seq, mode=mode, use_orient=use_orient,
                                  detect_disulf=ss)
    jpool = {k: jnp.stack([jnp.asarray(n[k]) for n in npzs]) for k in NAMES}
    tpool = {k: torch.from_numpy(np.stack([n[k] for n in npzs]))
             for k in NAMES}
    jrows, trows = np.asarray(jc.count(jpool)), tc.count(tpool).numpy()
    P = tuple(jcompact._bucket(int(c)) for c in jrows[0])
    if lane_map is None:
        lane_map = np.repeat(np.arange(len(npzs)), lanes_per_row)
    jout = jc.compile(jpool, jnp.asarray(lane_map, jnp.int32), P)
    tout = tc.compile(tpool, lane_map, P)
    return (jrows, trows), jout, tout


def test_stage_ranges_match_jax():
    for mode in (0, 1, 2):
        assert ttablegen._stage_ranges(mode, 40) == \
            jtablegen._stage_ranges(mode, 40)
    with pytest.raises(ValueError):
        ttablegen._stage_ranges(3, 40)


@pytest.mark.parametrize("case", sorted(CASES))
def test_counts_pairs_and_acts_match_jax(case):
    (jrows, trows), (jur, jst, jr1, jr2), (tur, tst, tr1, tr2) = \
        _compile_both(case)
    assert np.array_equal(trows, jrows)                   # both count rows
    assert (trows[1] >= trows[0]).all()
    assert len(tst) == len(jst) == (3 if case == "mode0" else 1)
    for name in NAMES:
        jt, tt = getattr(jur, name), getattr(tur, name)
        assert np.array_equal(tt.i.idx.numpy(), np.asarray(jt.i))
        assert np.array_equal(tt.j.idx.numpy(), np.asarray(jt.j))
        assert np.array_equal(tt.x.numpy(), np.asarray(jt.x))
        for ja, ta in zip(list(jst) + [jr1, jr2], list(tst) + [tr1, tr2]):
            assert np.array_equal(getattr(ta, name).numpy().T,
                                  np.asarray(getattr(ja, name)))


@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_match_jax(case):
    """y within TABLE_TOL of the term's largest |y|; m = y @ op elementwise
    within TABLE_TOL of |y| @ |op| (both packages round the product in
    float32: the disulfide well's y reaches ~2.5e3 where its m is ~20)."""
    _check_tables(*_compile_both(case)[1:])


def _check_tables(jout, tout):
    (jur, *_), (tur, *_) = jout, tout
    for name in NAMES:
        jt, tt = getattr(jur, name), getattr(tur, name)
        y_ref = np.asarray(jt.y).transpose(1, 0, 2)
        m_ref = np.asarray(jt.m).transpose(1, 0, 2)
        y, m = (a.numpy() for a in tops.expand_lane_tables(tt.tab, tt.row))
        assert y.shape == y_ref.shape and m.shape == m_ref.shape
        assert np.abs(y - y_ref).max() <= TABLE_TOL * np.abs(y_ref).max()
        op = tspline._second_derivative_operator(
            tt.x.numpy().astype(np.float64))
        scale = np.abs(y_ref).astype(np.float64) @ np.abs(op).T
        assert (np.abs(m - m_ref) <= TABLE_TOL * scale).all(), name


def test_initial_fold_map_builds_only_the_rows_it_uses():
    """The initial fold's lane map fans few pool rows out to many lanes
    (driver.py: 13 lanes a model, padded with the last): 2 rows over 8
    lanes, with a pool row between them unused, build 2 table rows, and
    expanded with the map they are JAX's per-lane tables."""
    lane_map = np.array([0, 0, 0, 2, 2, 2, 2, 2])
    _, jout, tout = _compile_both("three_lanes", lane_map=lane_map)
    for name in NAMES:
        t = getattr(tout[0], name)
        assert t.tab.shape[1] == 2
        assert t.tab.shape[2:] == (t.x.shape[0] - 1, 4)
        assert t.row.dtype == torch.int32
        assert t.row.tolist() == [0, 0, 0, 1, 1, 1, 1, 1]
    _check_tables(jout, tout)


def test_no_orient_tables_are_flat():
    (jrows, trows), (jur, jst, *_), (tur, tst, *_) = _compile_both(
        "plain", use_orient=False)
    assert np.array_equal(trows, jrows)
    for name in NAMES[1:]:
        assert not getattr(tur, name).tab.any()
        assert not getattr(tst[0], name).any()
        assert not np.asarray(getattr(jst[0], name)).any()
    assert np.array_equal(tst[0].dist.numpy().T, np.asarray(jst[0].dist))


def test_nonzero_padded_is_jax_nonzero():
    rng = np.random.default_rng(3)
    for n_true in (0, 5, 17):
        mask = np.zeros(40, bool)
        mask[rng.choice(40, n_true, replace=False)] = True
        port = ttablegen._nonzero_padded(torch.from_numpy(mask), 24)
        (ref,) = jnp.nonzero(jnp.asarray(mask), size=24, fill_value=1)
        assert np.array_equal(port.numpy(), np.asarray(ref))


def test_rows_on_device():
    """The gather's backward rows: positions sorted by residue (stable)
    and each residue's first position, as numpy makes them."""
    idx = np.array([3, 0, 1, 3, 0, 0, 5], np.int64)
    rows = tcompact.rows_on_device(torch.from_numpy(idx), 7)
    assert np.array_equal(rows.idx.numpy(), idx)
    assert np.array_equal(rows.order.numpy(), np.argsort(idx, kind="stable"))
    assert np.array_equal(rows.offsets.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(idx, minlength=7))]))


def _lanes_inputs(seed, M=3, P=40, K=28):
    """Per-lane tables fitted on the torsion knots, queries below, on and
    above the knots, and per-lane masks (numpy)."""
    rng = np.random.default_rng(seed)
    x = np.asarray(ttablegen.torsion_knots(), np.float32)
    y = rng.normal(size=(M, P, K)).astype(np.float32)
    op = tspline._second_derivative_operator(x.astype(np.float64))
    m = np.einsum("...n,kn->...k", y, op.astype(np.float32))
    q = rng.uniform(x[0] - 1.0, x[-1] + 1.0, (M, P)).astype(np.float32)
    q[:, :3] = [x[0] - 0.5, x[-1], x[-1] + 0.5]
    mask = rng.random((M, P)) < 0.7
    return y, m, x, q, mask


def test_masked_spline_energy_lanes_matches_jax():
    y, m, x, q, mask = _lanes_inputs(seed=1)
    qt = torch.from_numpy(q).requires_grad_(True)
    e = tspline.masked_spline_energy_lanes(
        torch.from_numpy(y), torch.from_numpy(m), torch.from_numpy(x), qt,
        torch.from_numpy(mask))
    (e * torch.arange(1.0, 4.0)).sum().backward()
    args = [jnp.asarray(a) for a in (y, m, x)]
    ref_e, pull = jax.vjp(lambda qq: jspline.masked_spline_energy_lanes(
        *args, qq, jnp.asarray(mask)), jnp.asarray(q))
    (ref_g,) = pull(jnp.arange(1.0, 4.0))
    ref_e, ref_g = np.asarray(ref_e), np.asarray(ref_g)
    assert np.abs(e.detach().numpy() - ref_e).max() <= \
        VALUE_TOL * np.abs(ref_e).max()
    assert np.abs(qt.grad.numpy() - ref_g).max() <= 1e-5 * max(
        1.0, np.abs(ref_g).max())


def test_spline_lanes_plain_matches_masked_spline_energy_lanes():
    """The kernel's plain version (pair-major, four terms at once) against
    the lane-major op, term by term: same arithmetic, equal bits."""
    terms, qs, ref = [], [], []
    for seed in range(4):
        y, m, x, q, mask = (torch.from_numpy(a)
                            for a in _lanes_inputs(seed + 5, P=30 + seed))
        terms.append((tops.interval_tables(y.transpose(0, 1),
                                           m.transpose(0, 1)),
                      torch.arange(y.shape[0], dtype=torch.int32), x,
                      mask.T.contiguous()))
        qs.append(q.T.contiguous())
        ref.append(tspline.masked_spline_energy_lanes(y, m, x, q, mask))
    sums, derivs = tops.spline_lanes_plain(terms, qs)
    # the same values summed along another axis: float32 rounding only
    assert torch.allclose(sums, torch.stack(ref), rtol=1e-6, atol=1e-5)
    tables = tops.SplineLanes(terms)
    out = tops.spline_energy_lanes(tables, [q.requires_grad_(True)
                                            for q in qs])
    assert torch.equal(out, sums)
    out.sum().backward()
    for q, d in zip(qs, derivs):
        assert torch.equal(q.grad, d)


def _expanded_plain(terms, qs):
    """The per-lane plain evaluation (evaluate_spline_with_deriv over
    (P, C, K) tables, the lanes entry's plain version before its tables
    were stored per row) on the expansion of row-mapped terms."""
    sums, derivs = [], []
    for (tab, row, x, act), q in zip(terms, qs):
        y, m = tops.expand_lane_tables(tab, row)
        val, der = tspline.evaluate_spline_with_deriv(
            tspline.SplineTable(x, y, m), q)
        sums.append(torch.where(act, val, 0.0).sum(dim=0))
        derivs.append(torch.where(act, der, 0.0))
    return torch.stack(sums), derivs


@pytest.mark.parametrize("row_map", ["repeated", "identity"])
def test_spline_lanes_plain_row_map_matches_expanded_tables(row_map):
    """The plain lanes version over U' row tables and a lane -> row map
    equals, bit for bit, the per-lane plain version over the tables the
    map expands to: queries below x[0], at and above x[K-1], lanes that
    share rows, and masked lanes whose table holds inf or NaN."""
    C, P = 6, 24
    rows = np.array([0, 0, 2, 1, 2, 2]) if row_map == "repeated" \
        else np.arange(C)
    row = torch.as_tensor(rows, dtype=torch.int32)
    on_1 = torch.as_tensor(rows == 1)       # the lanes reading row 1
    terms, qs = [], []
    for seed in (20, 21):
        y, m, x, _, _ = (torch.from_numpy(a) for a in _lanes_inputs(
            seed, M=int(rows.max()) + 1, P=P))
        tab = tops.interval_tables(y.transpose(0, 1), m.transpose(0, 1))
        rng = np.random.default_rng(seed)
        q = rng.uniform(x[0] - 1.0, x[-1] + 1.0, (P, C)).astype(np.float32)
        q[:3] = np.array([x[0] - 0.5, x[-1], x[-1] + 0.5],
                         np.float32)[:, None]
        act = torch.from_numpy(rng.random((P, C)) < 0.7)
        # pairs 5..7 of row 1 hold NaN and inf; every lane on row 1 is
        # masked there
        act[5:8] &= ~on_1
        tab[5, 1] = float("nan")
        tab[6, 1, :, 0] = float("inf")
        tab[7, 1, :, 3] = -float("inf")
        terms.append((tab, row, x, act))
        qs.append(torch.from_numpy(q))
    sums, derivs = tops.spline_lanes_plain(terms, qs)
    ref_sums, ref_derivs = _expanded_plain(terms, qs)
    assert bool(torch.isfinite(sums).all())
    assert torch.equal(sums, ref_sums)
    for d, r in zip(derivs, ref_derivs):
        assert bool(torch.isfinite(d).all()) and torch.equal(d, r)


def test_spline_lanes_rejects_malformed_tables():
    y, m, x, q, mask = (torch.from_numpy(a) for a in _lanes_inputs(2))
    tab = tops.interval_tables(y.transpose(0, 1), m.transpose(0, 1))
    row = torch.arange(y.shape[0], dtype=torch.int32)
    act = mask.T.contiguous()
    good = (tab, row, x, act)
    tops.SplineLanes([good])
    misaligned = torch.empty(tab.numel() + 1).narrow(0, 1, tab.numel()) \
        .view(tab.shape)
    bad = [
        (y.transpose(0, 1).contiguous(), row, x, act),   # (P, C, K) y
        (tab, row, x, mask.contiguous()),                # act (C, P)
        (tab, row, x, act.float()),                      # act not bool
        (tab, row.long(), x, act),                       # map not int32
        (tab, row[:2], x, act),                          # map of 2 lanes
        (tab.transpose(0, 1), row, x, act),              # not contiguous
        (tab, row, torch.zeros(1), act),                 # one knot
        (misaligned, row, x, act),                       # not 16-B aligned
    ]
    for terms in bad:
        with pytest.raises(ValueError):
            tops.SplineLanes([terms])
    other_c = (tab, row[:2].contiguous(), x, act[:, :2].contiguous())
    with pytest.raises(ValueError):
        tops.SplineLanes([good, other_c])                # two lane counts


def test_union_take_lanes_matches_compiling_those_lanes():
    """Repacking lanes selects from the lane -> row map and the activity
    only, the tables stay where they are, and the taken lanes' energies
    are those of compiling those lanes."""
    _, _, (tur, tst, *_) = _compile_both("three_lanes", lanes_per_row=1)
    sel = [2, 0]
    ur, acts = tcompact.union_take_lanes(tur, tst[0], sel)
    _, _, (ref, rst, *_) = _compile_both("three_lanes",
                                         lane_map=np.array(sel))
    for name in NAMES:
        t, full, r = getattr(ur, name), getattr(tur, name), getattr(ref, name)
        assert t.tab is full.tab and t.i is full.i and t.x is full.x
        assert torch.equal(t.row, full.row[sel])
        assert torch.equal(t.i.idx, r.i.idx)
        assert torch.equal(getattr(acts, name), getattr(rst[0], name))
        for a, b in zip(tops.expand_lane_tables(t.tab, t.row),
                        tops.expand_lane_tables(r.tab, r.row)):
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-6)
    w = torch.as_tensor(tenergy.weights_to_vec(tenergy.SCOREFXN_CENT))
    x = torch.as_tensor(_torsions(2, 16, seed=3), dtype=torch.float32)
    e = tenergy.batched_energy_weighted_union(
        x, tcompact.union_stage(ur, acts), w)
    e_ref = tenergy.batched_energy_weighted_union(
        x, tcompact.union_stage(ref, rst[0]), w)
    assert torch.allclose(e, e_ref, rtol=VALUE_TOL, atol=0.0)


def _torsions(M, L, seed):
    rng = np.random.default_rng(seed)
    from trx2dy.physics.folder import _BASIN_P, _BASIN_PHI, _BASIN_PSI
    basin = rng.choice(6, size=(M, L), p=_BASIN_P)
    return np.stack([_BASIN_PHI[basin], _BASIN_PSI[basin],
                     np.full((M, L), np.pi)], axis=1).reshape(M, -1)


def _port_stage(jur, jacts, dtype):
    """JAX's compiled union tables as the port's stage (pair-major interval
    tables, one row per lane under the identity map, the pair lists as
    device rows), in dtype."""
    terms = []
    for t in jur:
        L = 1 + int(max(np.asarray(t.i).max(), np.asarray(t.j).max()))
        y, m = (torch.as_tensor(np.asarray(a).transpose(1, 0, 2).copy(),
                                dtype=dtype) for a in (t.y, t.m))
        terms.append(tcompact.UnionTerm(
            i=tcompact._rows(np.array(t.i), L, "cpu"),
            j=tcompact._rows(np.array(t.j), L, "cpu"),
            tab=tops.interval_tables(y, m),
            row=torch.arange(y.shape[1], dtype=torch.int32),
            x=torch.as_tensor(np.array(t.x), dtype=dtype)))
    acts = tcompact.UnionActs(*(torch.from_numpy(np.asarray(a).T.copy())
                                for a in jacts))
    return tcompact.union_stage(tcompact.UnionRestraints(*terms), acts)


def _cast(tree, dtype):
    return jax.tree.map(
        lambda a: a.astype(dtype) if a.dtype == jnp.float32 else a, tree)


@jax.jit
def _jax_union_vg(x, ur, acts, w, cot):
    e, pull = jax.vjp(lambda xx: jenergy.batched_energy_weighted_union(
        xx, ur, acts, w), x)
    return e, pull(cot)[0]


@jax.jit
def _jax_cart_vg(t, delta, ur, acts, w):
    from trx2dy.geometry.nerf import build_backbone
    atoms = jax.vmap(lambda tt: build_backbone(tt[0], tt[1], tt[2]))(t)
    e, pull = jax.vjp(jcartmin._cart_efun(atoms, (ur, acts), w, "union"),
                      delta)
    return e, pull(jnp.ones_like(e))[0], atoms


PRECISIONS = (("f32", jnp.float32, torch.float32),
              ("f64", jnp.float64, torch.float64))


def _check(prec, e, ref_e, g, ref_g):
    if prec == "f32":
        assert np.abs(e - ref_e).max() <= VALUE_TOL * np.abs(ref_e).max()
    else:
        assert np.abs(g - ref_g).max() <= GRAD_TOL * np.abs(ref_g).max()


@pytest.mark.parametrize("scorefxn", ["SCOREFXN_CENT", "SCOREFXN1"])
def test_union_energy_matches_jax(scorefxn):
    """batched_energy_weighted_union at tests/test_tablegen.py's union
    shapes (L=16, 3 lanes) on JAX's tables: values in float32, gradients
    in float64."""
    _, (jur, jst, *_), _ = _compile_both("three_lanes", lanes_per_row=1)
    w = tenergy.weights_to_vec(getattr(tenergy, scorefxn))
    x = _torsions(3, 16, seed=7)
    cot = np.arange(1.0, 4.0)
    for prec, dt, tdt in PRECISIONS:
        xt = torch.as_tensor(x, dtype=tdt).requires_grad_(True)
        e = tenergy.batched_energy_weighted_union(
            xt, _port_stage(jur, jst[0], tdt), torch.as_tensor(w, dtype=tdt))
        (e * torch.as_tensor(cot, dtype=tdt)).sum().backward()
        with jax.enable_x64(prec == "f64"):
            ref_e, ref_g = _jax_union_vg(
                jnp.asarray(x, dt), _cast(jur, dt), jst[0], jnp.asarray(w, dt),
                jnp.asarray(cot, dt))
            ref_e, ref_g = np.asarray(ref_e), np.asarray(ref_g)
        _check(prec, e.detach().numpy(), ref_e, xt.grad.numpy(), ref_g)


def test_union_cartesian_energy_matches_jax():
    """The cartesian energy's "union" kind (_cart_efun) on JAX's tables at
    the same union: first energy and gradient of a small displacement from
    the NeRF build, both in float64 within GRAD_TOL (one JAX program)."""
    _, (jur, jst, *_), _ = _compile_both("three_lanes", lanes_per_row=1)
    w = tenergy.weights_to_vec(tenergy.SCOREFXN_CENT)
    t = _torsions(3, 16, seed=8).reshape(3, 3, 16)
    delta = 0.05 * np.random.default_rng(9).normal(size=(3, 15 * 16))
    for prec, dt, tdt in PRECISIONS[1:]:
        with jax.enable_x64(True):
            ref_e, ref_g, atoms = _jax_cart_vg(
                jnp.asarray(t, dt), jnp.asarray(delta, dt), _cast(jur, dt),
                jst[0], jnp.asarray(w, dt))
            ref_e, ref_g = np.asarray(ref_e), np.asarray(ref_g)
            atoms = {k: torch.as_tensor(np.array(v), dtype=tdt)
                     for k, v in atoms.items()}
        stage = _port_stage(jur, jst[0], tdt)
        assert tcartmin._table_kind(stage) == "union"
        dt_t = torch.as_tensor(delta, dtype=tdt).requires_grad_(True)
        e = tcartmin._cart_efun(atoms, stage, torch.as_tensor(w, dtype=tdt),
                                "union")(dt_t)
        e.sum().backward()
        assert np.abs(e.detach().numpy() - ref_e).max() <= \
            GRAD_TOL * np.abs(ref_e).max()
        _check(prec, e.detach().numpy(), ref_e, dt_t.grad.numpy(), ref_g)
