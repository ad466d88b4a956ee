"""The device first setup (``air/device_setup.py``, ``sparse/dell.py``,
``cf/device.py``) on the CPU, held against the JAX package's.

Both packages get the same numpy inputs: a JAX ``DELL`` made from a scipy
matrix is read back and turned into the port's with
``convert.dell_from_numpy``.  The DELL primitives, the CF splittings, the
device inverses and the lAIR solves agree to rounding (patterns equal,
values within 1e-12 or 1e-10 as stated).  The whole setup is held level
by level: a level's matrix (recorded as each package's splitting receives
it), its markers, its operators and the layouts ``_optimize_layouts``
chose.  From level 1 on the two packages' matrices differ by rounding
(their sums run in other orders), and adv_diff_2d puts entries exactly on
the strength threshold, the DDC bin edges and the one-point W's maximum,
so a level can split or pick W otherwise;
``pflare_tpu_torch/air/setup_compare.py::compare_setups`` then requires
that every differing decision is such a tie, the test records it with
the entry's value and its tolerance in its ``user_properties``, and the
hierarchies are held to the reference's own rule from there: GMRES
iterations within its host setup's + 3 (tests/test_device_setup.py:143).
The same options on adv_diff_2d's curved-velocity sibling meet no tie:
those hierarchies must agree on every level, and are held to the coarse
inverse, ``apply`` within 1e-10 and equal iterations.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import pflare_tpu as jpf
import pflare_tpu_torch as tpf
import pflare_tpu.air.device_setup as jds
import pflare_tpu.cf.device as jcfd
import pflare_tpu.sparse.dell as jdell
import pflare_tpu_torch.air.device_setup as tds
import pflare_tpu_torch.cf.device as tcfd
import pflare_tpu_torch.sparse.dell as tdell
from pflare_tpu_torch.convert import dell_from_numpy
from pflare_tpu_torch.air.setup_compare import (LevelMatrices, compare_setups,
                                               inverse_view, inverses_close,
                                               port_inverse_view,
                                               probe_vector, setup_levels)
from torch_reference import host_kernels  # noqa: F401

torch.set_num_threads(1)

VALUES_RTOL = 1e-12      # primitives and operators, of the largest entry
INVERSE_RTOL = 1e-10     # coefficients, assembled inverses, apply


def _rand_csr(n, m, density, seed, diag=None):
    """The random matrices of tests/test_device_setup.py:28-34."""
    A = sp.random(n, m, density=density, random_state=seed, format="csr")
    if diag is not None:
        A = sp.csr_matrix(A + sp.diags(np.full(min(n, m), diag),
                                       shape=(n, m)))
    A.sort_indices()
    return A


def _adv16():
    return sp.csr_matrix(jpf.adv_diff_2d(16))


MATRICES = {
    "rand120": lambda: _rand_csr(120, 120, 0.05, 0, diag=2.0),
    "rand100x80": lambda: _rand_csr(100, 80, 0.06, 1),
    "adv16": _adv16,
}


def jdl(A):
    return jdell.DELL.from_scipy(A, dtype=jnp.float64)


def port(jd):
    """The port's DELL of a JAX DELL's arrays."""
    return dell_from_numpy(np.array(jd.data), np.array(jd.cols), jd.n_cols,
                           device="cpu")


def close(a: sp.csr_matrix, b: sp.csr_matrix, rtol=VALUES_RTOL, what=""):
    """Equal patterns (explicit zeros dropped), values within ``rtol`` of
    the largest entry."""
    a, b = sp.csr_matrix(a), sp.csr_matrix(b)
    a.eliminate_zeros()
    b.eliminate_zeros()
    a.sort_indices()
    b.sort_indices()
    assert a.shape == b.shape, what
    assert np.array_equal(a.indptr, b.indptr) and np.array_equal(
        a.indices, b.indices), f"{what}: patterns differ"
    scale = max(abs(a).max() if a.nnz else 0.0, 1e-300)
    assert np.abs(a.data - b.data).max(initial=0.0) <= rtol * scale, what


def cols_of(c):
    """Rows of a padded cols array as sorted live sets."""
    c = np.asarray(c)
    return [sorted(r[r < tdell.PADCOL].tolist()) for r in c]


# ~~~~~~~~~~~~~~~~~~~~~~~~ DELL primitives ~~~~~~~~~~~~~~~~~~~~~~~~


@pytest.mark.parametrize("name", list(MATRICES))
def test_dell_roundtrip_and_matvec(name):
    A = MATRICES[name]()
    close(tdell.DELL.from_scipy(A, device="cpu").to_scipy(), A, 0.0,
          "from_scipy")
    J = jdl(A)
    T = port(J)
    close(T.to_scipy(), A, 0.0, "from the JAX arrays")
    x = np.random.default_rng(0).standard_normal(A.shape[1])
    yj = np.asarray(J.matvec(jnp.asarray(x)))
    yt = T.matvec(torch.as_tensor(x)).numpy()
    assert np.abs(yt - yj).max() <= VALUES_RTOL * np.abs(yj).max()
    np.testing.assert_allclose(T.diagonal().numpy(),
                               np.asarray(J.diagonal()), rtol=0, atol=0)
    assert T.row_counts().tolist() == np.asarray(J.row_counts()).tolist()


# (A, B, tol, relative, lump, diag_of_row): tests/test_device_setup.py:
# 47-72, the adv_diff square, an absolute drop and the coarse-rows RAP's
# protected diagonals
SPGEMM_CASES = {
    "plain": ("rand100x80", "rand80x90", 0.0, True, False, None),
    "drop0.1": ("rand150a", "rand150b", 0.1, True, False, None),
    "drop0.3_lump": ("rand150a", "rand150b", 0.3, True, True, None),
    "adv16_sq_lump": ("adv16", "adv16", 0.05, True, True, None),
    "absolute": ("rand150a", "rand150b", 0.05, False, False, None),
    "diag_of_row": ("adv16_rows", "adv16", 0.1, True, True, "rows"),
}
SPGEMM_MATS = {
    "rand100x80": lambda: _rand_csr(100, 80, 0.06, 1),
    "rand80x90": lambda: _rand_csr(80, 90, 0.05, 2),
    "rand150a": lambda: _rand_csr(150, 150, 0.04, 3, diag=3.0),
    "rand150b": lambda: _rand_csr(150, 150, 0.05, 4, diag=1.0),
    "adv16": _adv16,
    "adv16_rows": lambda: sp.csr_matrix(_adv16()[::3]),
}


@pytest.mark.parametrize("case", list(SPGEMM_CASES))
def test_spgemm_drop_matches_reference(case):
    a, b, tol, relative, lump, dor = SPGEMM_CASES[case]
    A, B = SPGEMM_MATS[a](), SPGEMM_MATS[b]()
    rows = np.arange(0, _adv16().shape[0], 3)
    jd = None if dor is None else jnp.asarray(rows, dtype=jnp.int32)
    td = None if dor is None else torch.as_tensor(rows, dtype=torch.int32)
    Cj = jdell.spgemm_drop_dell(jdl(A), jdl(B), tol, relative, lump,
                                diag_of_row=jd).to_scipy()
    Ct = tdell.spgemm_drop_dell(port(jdl(A)), port(jdl(B)), tol, relative,
                                lump, diag_of_row=td).to_scipy()
    close(Ct, Cj, what=case)
    if not lump and tol == 0.0:
        close(Ct, sp.csr_matrix(A @ B), what="scipy")
        c, v = tdell.spgemm_merge(port(jdl(A)), port(jdl(B)))
        close(tdell.DELL(v, c, B.shape[1]).to_scipy(), Cj, what="merge")


def test_spgemm_chunked_matches_whole(monkeypatch):
    """The row-chunked product (above _SPGEMM_CHUNK_LIMIT candidates,
    here chunks of a few rows, each compacted to its own width) gives the
    whole product's result."""
    A = _rand_csr(300, 300, 0.03, 5, diag=2.0)
    whole = tdell.spgemm_drop_dell(port(jdl(A)), port(jdl(A)), 0.1, True,
                                   True).to_scipy()
    monkeypatch.setattr(tdell, "_SPGEMM_CHUNK_LIMIT", 64 * 30)
    chunked = tdell.spgemm_drop_dell(port(jdl(A)), port(jdl(A)), 0.1, True,
                                     True).to_scipy()
    close(chunked, whole, 0.0)


@pytest.mark.parametrize("ensure_diag", [False, True])
@pytest.mark.parametrize("compact_width", [False, True])
def test_extract_matches_reference(ensure_diag, compact_width):
    A = _rand_csr(90, 90, 0.08, 5, diag=2.0)
    mask = np.random.default_rng(1).random(90) < 0.4
    idx = np.nonzero(mask)[0]
    newidx = np.cumsum(mask) - 1
    Sj = jdell.extract_dell(jdl(A), jnp.asarray(idx), jnp.asarray(mask),
                            jnp.asarray(newidx), len(idx), ensure_diag,
                            compact_width)
    St = tdell.extract_dell(port(jdl(A)), torch.as_tensor(idx),
                            torch.as_tensor(mask), torch.as_tensor(newidx),
                            len(idx), ensure_diag, compact_width)
    close(St.to_scipy(), Sj.to_scipy(), 0.0)
    close(St.to_scipy(), A[idx][:, idx], 0.0, "scipy")
    if ensure_diag:
        assert cols_of(St.cols) == cols_of(Sj.cols)


@pytest.mark.parametrize("relative", [True, False])
@pytest.mark.parametrize("lump", [False, True])
def test_drop_rows_and_compact_match_reference(relative, lump):
    J = jdl(_rand_csr(100, 100, 0.1, 7, diag=1.5))
    tol = 0.3 if relative else 0.4
    cj, vj = jdell.drop_rows(J.cols, J.data, tol, relative, lump)
    T = port(J)
    ct, vt = tdell.drop_rows(T.cols, T.data, tol, relative, lump)
    assert np.array_equal(np.asarray(cj), ct.numpy())
    assert np.abs(np.asarray(vj) - vt.numpy()).max() <= VALUES_RTOL
    K = tdell.max_row_count(ct)
    assert K == jdell.max_row_count(cj)
    c, v = tdell.compact(ct, vt, K)
    assert c.shape[1] == K
    close(tdell.DELL(v, c, 100).to_scipy(),
          jdell.DELL(vj, cj, 100).to_scipy(), VALUES_RTOL)


def test_onecol_product_matches_reference():
    A = _adv16()
    n = A.shape[0]
    rng = np.random.default_rng(2)
    pcol = np.where(rng.random(n) < 0.8, rng.integers(0, 100, n),
                    tdell.PADCOL).astype(np.int32)
    pval = np.where(pcol < tdell.PADCOL, rng.standard_normal(n), 0.0)
    Cj = jdell.onecol_product(jdl(A), jnp.asarray(pcol), jnp.asarray(pval),
                              100).to_scipy()
    Ct = tdell.onecol_product(port(jdl(A)), torch.as_tensor(pcol),
                              torch.as_tensor(pval), 100).to_scipy()
    close(Ct, Cj)


@pytest.mark.parametrize("name", ["rand80", "adv16"])
def test_poly_dell_matches_reference(name):
    A = (_rand_csr(80, 80, 0.06, 6, diag=4.0) if name == "rand80"
         else _adv16())
    coeffs = np.random.default_rng(2).standard_normal(7)
    Mj = jdell.poly_dell(jdl(A), jnp.asarray(coeffs)).to_scipy()
    Mt = tdell.poly_dell(port(jdl(A)), torch.as_tensor(coeffs)).to_scipy()
    close(Mt, Mj)


@pytest.mark.parametrize("name", ["rand70", "adv16"])
def test_newton_poly_dell_matches_reference(name):
    A = (_rand_csr(70, 70, 0.07, 7, diag=4.0) if name == "rand70"
         else _adv16())
    rng = np.random.default_rng(3)
    wr = rng.standard_normal(6) + 3
    wi = np.zeros(6)
    wi[2], wi[3] = 0.4, -0.4
    Mj = jdell.newton_poly_dell(jdl(A), wr, wi, 1e-14).to_scipy()
    Mt = tdell.newton_poly_dell(port(jdl(A)), wr, wi, 1e-14).to_scipy()
    close(Mt, Mj)


@pytest.mark.parametrize("name", ["rand60x45", "adv16"])
def test_transpose_and_union_match_reference(name):
    B = _rand_csr(60, 45, 0.08, 8) if name == "rand60x45" else _adv16()
    Tj = np.asarray(jdell.transpose_pattern(jdl(B)))
    Tt = tdell.transpose_pattern(port(jdl(B)))
    assert cols_of(Tt) == cols_of(Tj)
    Bt = sp.csr_matrix(B.T)
    Bt.sort_indices()
    assert cols_of(Tt) == [Bt.indices[Bt.indptr[i]:Bt.indptr[i + 1]].tolist()
                           for i in range(Bt.shape[0])]
    if B.shape[0] == B.shape[1]:
        w = max(Tt.shape[1], port(jdl(B)).K)
        c = tdell._pad_cols(port(jdl(B)).cols, w)
        t = tdell._pad_cols(Tt, w)
        Uj = jdell.union_patterns(jnp.asarray(c.numpy()),
                                  jnp.asarray(t.numpy()))
        assert cols_of(tdell.union_patterns(c, t)) == cols_of(Uj)


@pytest.mark.parametrize("name", ["rand80", "adv16"])
def test_restriction_plan_and_gather_match_reference(name):
    A = (_rand_csr(80, 80, 0.06, 9, diag=4.0) if name == "rand80"
         else _adv16())
    J, T = jdl(A), port(jdl(A))
    X = jdell.poly_dell(J, jnp.asarray([0.5, 1.0, -0.25]))
    Xv = np.random.default_rng(4).standard_normal(np.asarray(X.data).shape)
    Xv = np.where(np.asarray(X.cols) < tdell.PADCOL, Xv, 0.0)
    Xc = np.array(X.cols)
    Pj = np.asarray(jdell.restrict_plan(jnp.asarray(Xc), J))
    Pt = tdell.restrict_plan(torch.as_tensor(Xc), T).numpy()
    assert np.abs(Pt - Pj).max() == 0.0
    yj = np.asarray(jdell.apply_restrict_plan(jnp.asarray(Pj),
                                              jnp.asarray(Xv)))
    yt = tdell.apply_restrict_plan(torch.as_tensor(Pt),
                                   torch.as_tensor(Xv)).numpy()
    assert np.abs(yt - yj).max() <= VALUES_RTOL * np.abs(yj).max()
    rj = np.asarray(jdell.restricted_product(jnp.asarray(Xc),
                                             jnp.asarray(Xv), J))
    rt = tdell.restricted_product(torch.as_tensor(Xc), torch.as_tensor(Xv),
                                  T).numpy()
    assert np.abs(rt - rj).max() <= VALUES_RTOL * np.abs(rj).max()
    # values of A at X's (wider) pattern
    gj = np.asarray(jdell.gather_at_pattern(jnp.asarray(Xc), J))
    gt = tdell.gather_at_pattern(torch.as_tensor(Xc), T).numpy()
    assert np.array_equal(gt, gj)


@pytest.mark.parametrize("name", ["adv16", "rand120", "adv_3d"])
def test_distinct_offsets_match_reference(name):
    A = (jpf.adv_diff_3d(6) if name == "adv_3d" else MATRICES[name]())
    J = jdl(sp.csr_matrix(A))
    cj = np.asarray(jdell.distinct_offsets_device(J.cols, cap=16))
    ct = tdell.distinct_offsets_device(port(J).cols, cap=16).numpy()
    assert np.array_equal(ct, cj)


# ~~~~~~~~~~~~~~~~~~~~~~~~ CF splitting ~~~~~~~~~~~~~~~~~~~~~~~~

SPLIT_MATRICES = {
    "adv48_0.99": (lambda: jpf.adv_diff_2d(48), 0.99),
    "curved48_0.5": (lambda: jpf.adv_diff_2d(48, curved_velocity=True), 0.5),
}


@pytest.mark.parametrize("kind", ["PMISR_DDC", "PMIS", "PMIS_DIST2", "CR"])
@pytest.mark.parametrize("mat", list(SPLIT_MATRICES))
def test_cf_split_matches_reference(mat, kind):
    """The reference takes its gather-free ``_split_fused_dia`` on these
    stencils; the port's ``_split_fused`` gives its markers."""
    make, theta = SPLIT_MATRICES[mat]
    J = jdl(sp.csr_matrix(make()))
    cfj, nj = jds._cf_split_device(J, jpf.AIROptions(
        strong_threshold=theta,
        cf_splitting_type=getattr(jpf.CFSplittingType, kind)))
    cft, nt = tds._cf_split_device(port(J), tpf.AIROptions(
        strong_threshold=theta).replace(cf_splitting_type=kind))
    assert np.array_equal(cft.numpy(), np.asarray(cfj))
    assert int(nt) == jds._read_pair(nj)


@pytest.mark.parametrize("pmis", [False, True])
@pytest.mark.parametrize("steps", [3, -1])
def test_pmisr_on_device_matches_reference(pmis, steps):
    A = jpf.adv_diff_2d(24)
    S = sp.csr_matrix(abs(A) > 0.3, dtype=float)
    S.setdiag(0)
    S.eliminate_zeros()
    cj = jcfd.pmisr_on_device(S, max_luby_steps=steps, pmis=pmis)
    ct = tcfd.pmisr_on_device(S, max_luby_steps=steps, pmis=pmis,
                              device="cpu")
    assert np.array_equal(ct, cj)


# ~~~~~~~~~~~~~~~~~~~~~~~~ device inverses ~~~~~~~~~~~~~~~~~~~~~~~~


def _aff_pair():
    """A_ff of adv_diff_2d(16) on a seeded F set, with its diagonal
    (the input of _inverse_device in the level loop)."""
    A = _adv16()
    n = A.shape[0]
    is_f = np.random.default_rng(11).random(n) < 0.6
    idx = np.nonzero(is_f)[0]
    newidx = np.cumsum(is_f) - 1
    Jf = jdell.extract_dell(jdl(A), jnp.asarray(idx), jnp.asarray(is_f),
                            jnp.asarray(newidx), len(idx), ensure_diag=True)
    return Jf, port(Jf)


INVERSE_TYPES = ("JACOBI", "WJACOBI", "NEUMANN", "POWER", "ARNOLDI",
                 "NEWTON", "NEWTON_NO_EXTRA")


@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("mf", [False, True])
@pytest.mark.parametrize("kind", INVERSE_TYPES)
def test_inverse_device_matches_reference(kind, mf, scale):
    Jf, Tf = _aff_pair()
    jo = jpf.AIROptions(diag_scale_polys=scale)
    to = tpf.AIROptions(diag_scale_polys=scale)
    it = getattr(jpf.InverseType, kind)
    ij = jds._inverse_device(Jf, jo, it, 6, mf, 17, jnp.float64)
    iv = tds._inverse_device(Tf, to, int(it), 6, mf, 17, torch.float64)
    assert iv.kind == ij.kind
    if ij.coefficients is not None:
        cj = np.asarray(ij.coefficients)
        ct = iv.coefficients.numpy()
        assert ct.shape == cj.shape
        assert np.abs(ct - cj).max() <= INVERSE_RTOL * np.abs(cj).max()
    if ij.kind == "diagonal":
        dj = np.asarray(ij.diag)
        assert np.abs(iv.diag.numpy() - dj).max() <= (INVERSE_RTOL
                                                      * np.abs(dj).max())
    elif ij.kind == "assembled":
        close(iv.mat.to_scipy(), ij.mat.to_scipy(), INVERSE_RTOL)
    x = np.random.default_rng(5).standard_normal(Jf.shape[0])
    yj = np.asarray(ij.apply(jnp.asarray(x)))
    yt = iv.apply(torch.as_tensor(x)).numpy()
    assert np.abs(yt - yj).max() <= INVERSE_RTOL * np.abs(yj).max()


def test_assembled_scaled_inverse_is_not_the_hosts():
    """Reference fault (ROADMAP queue 3): under diag_scale_polys the
    reference's device path assembles the polynomial of A with the
    coefficients of D^-1 A (pflare_tpu/air/device_setup.py:993), where its
    host build (the port's, held to the reference's host build by
    tests/test_torch_inverse.py) assembles q(D^-1 A) D^-1; the port keeps
    the device path's values (the test above) and this shows that the
    reference's device and host inverses disagree."""
    from pflare_tpu_torch.inverse.build import build_inverse

    A = _rand_csr(80, 80, 0.06, 6, diag=4.0)
    A = sp.csr_matrix(sp.diags(np.linspace(1.0, 3.0, 80)) @ A)
    A.sort_indices()
    host = build_inverse(A, tpf.InverseType.ARNOLDI, poly_order=6,
                         diag_scale=True).host_csr
    dev = jds._inverse_device(jdl(A), jpf.AIROptions(diag_scale_polys=True),
                              jpf.InverseType.ARNOLDI, 6, False, 17,
                              jnp.float64).mat.to_scipy()
    assert abs(dev - host).max() > 1e-3 * abs(host).max()



@pytest.mark.parametrize("kw, on_host", [
    (dict(), True),                              # assembled smoother
    (dict(matrix_free_polys=True), True),        # AIRG's Z assembles it
    (dict(matrix_free_polys=True, z_type="LAIR"), True),  # the coarsest
    (dict(matrix_free_polys=True, z_type="LAIR",
          coarsest_matrix_free_polys=True), False),
])
def test_diag_scaled_assembled_polynomials_set_up_on_the_host(kw, on_host,
                                                             capsys):
    """Where the reference's device path would assemble a polynomial of A
    with the coefficients of D^-1 A (the test above), ``setup_device``
    prints why and takes the host setup, whose inverse is q(D^-1 A) D^-1;
    with every polynomial matrix-free it stays on the device."""
    from pflare_tpu_torch.air.hierarchy import Hierarchy

    o = tpf.AIROptions(diag_scale_polys=True, max_levels=3).replace(**kw)
    A = jpf.adv_diff_2d(16)
    pc = tpf.PCAIR(o, dtype=torch.float64, device="cpu").setup_device(A)
    err = capsys.readouterr().err
    assert ("diag_scale_polys with an assembled polynomial" in err) == on_host
    assert isinstance(pc.hierarchy, Hierarchy if on_host
                      else tds.DeviceSetupHierarchy)
    if on_host:
        with pytest.raises(ValueError, match="diag_scale_polys"):
            tds.setup_hierarchy_device(A, o, torch.float64, "cpu")
    b = np.random.default_rng(2).standard_normal(A.shape[0])
    assert pc.solve(b, rtol=1e-8, max_it=40).converged


# ~~~~~~~~~~~~~~~~~~~~~~~~ lAIR Z ~~~~~~~~~~~~~~~~~~~~~~~~


@pytest.mark.parametrize("incomplete", [True, False])
@pytest.mark.parametrize("distance", [1, 2])
def test_lair_z_matches_reference_and_host(distance, incomplete,
                                           host_kernels):
    """tests/test_device_setup.py:321-349 on a seeded CF splitting: within
    1e-10 of the reference's device Z and 1e-8 of the port's host sai_z
    (the reference's own rule)."""
    from pflare_tpu_torch.air.operators import lair_sparsity
    from pflare_tpu_torch.inverse.sai import sai_z

    A = _adv16()
    n = A.shape[0]
    cf = np.where(np.random.default_rng(3).random(n) < 0.6, -1, 1)
    fine, coarse = np.nonzero(cf == -1)[0], np.nonzero(cf == 1)[0]
    A_ff = sp.csr_matrix(A[fine][:, fine])
    A_cf = sp.csr_matrix(A[coarse][:, fine])
    Jff, Jcf = jdl(A_ff), jdl(A_cf)
    Zj = jds._lair_z_device(Jff, Jcf, Jff, Jcf, distance,
                            incomplete).to_scipy()
    Zt = tds._lair_z_device(port(Jff), port(Jcf), port(Jff), port(Jcf),
                            distance, incomplete).to_scipy()
    close(Zt, Zj, INVERSE_RTOL)
    Zh = sai_z(A_ff, A_cf, lair_sparsity(A_ff, A_cf, distance),
               incomplete=incomplete)
    Zt.eliminate_zeros()
    Zh.eliminate_zeros()
    assert abs(Zt - Zh).max() < 1e-8


# ~~~~~~~~~~~~~~~~~~~~~~~~ the whole setup ~~~~~~~~~~~~~~~~~~~~~~~~

# tests/test_device_setup.py:112-120 (BENCH_OPTS at 48^2) and :289-320
# (the six lAIR / strong-R / improve_z variants at 32^2), whose
# adv_diff_2d puts entries on the decisions' edges; and the same options
# on the curved-velocity sibling, whose entries sit on no edge, so the
# two packages build the same hierarchy to the last level
BENCH = dict(a_lump=True, a_drop=1e-5, strong_threshold=0.99, max_levels=4,
             coarsest_inverse_type="NEWTON", coarsest_poly_order=10,
             coarsest_matrix_free_polys=True)
LAIR = dict(a_drop=1e-4, max_levels=4)


def _adv(N, curved=False):
    return lambda: jpf.adv_diff_2d(N, curved_velocity=curved)


# name: (matrix, options, RHS seed, GMRES cap, free of ties)
SETUPS = {
    "bench48": (_adv(48), BENCH, 1, 12, False),
    "lair": (_adv(32), dict(LAIR, z_type="LAIR"), 7, 16, False),
    "sai_lair": (_adv(32), dict(LAIR, z_type="LAIR_SAI"), 7, 16, False),
    "lair_strong_r": (_adv(32), dict(LAIR, z_type="LAIR",
                                     strong_r_threshold=0.01), 7, 16, False),
    "airg_strong_r": (_adv(32), dict(LAIR, strong_r_threshold=0.01), 7, 16,
                      False),
    "airg_improve_z": (_adv(32), dict(LAIR, improve_z_its=2), 7, 16, False),
    "lair_improve_z": (_adv(32), dict(LAIR, z_type="LAIR", improve_z_its=1),
                       7, 16, False),
    "bench_curved48": (_adv(48, True), BENCH, 1, 12, True),
    "lair_curved32": (_adv(32, True), dict(LAIR, z_type="LAIR"), 7, 16,
                      True),
    "sai_lair_curved32": (_adv(32, True), dict(LAIR, z_type="LAIR_SAI"), 7,
                          16, True),
    "lair_strong_r_curved32": (_adv(32, True), dict(
        LAIR, z_type="LAIR", strong_r_threshold=0.01), 7, 16, True),
    "airg_improve_z_curved32": (_adv(32, True), dict(LAIR, improve_z_its=2),
                                7, 16, True),
}


def _jax_options(kw):
    conv = {"z_type": jpf.ZType, "coarsest_inverse_type": jpf.InverseType,
            "inverse_type": jpf.InverseType,
            "cf_splitting_type": jpf.CFSplittingType}
    return jpf.AIROptions(**{k: (getattr(conv[k], v) if k in conv else v)
                             for k, v in kw.items()})


def _jax_levels(h) -> list:
    """``setup_levels`` views of a JAX device hierarchy."""
    out = []
    for lvl in h.levels:
        d = lvl.device
        out.append({
            "n": lvl.n, "fine": np.asarray(d["fine"]),
            "coarse": np.asarray(d["coarse"]),
            "ops": {k: (type(d[k]).__name__,
                        getattr(d[k], "offsets", None), d[k].to_scipy())
                    for k in ("A_ff", "A_fc", "R", "P")},
            "inv": inverse_view(d["inv_Aff"], d["inv_Aff"].apply(
                jnp.asarray(probe_vector(lvl.n))))})
    return out


@pytest.fixture(scope="module")
def reference_setups():
    """The JAX package's device setups, built once per worker and shared
    by the cases that need them: {name: (PCAIR, level matrices)}."""
    return {}


def _reference(name, cache):
    if name not in cache:
        make, kw = SETUPS[name][:2]
        with LevelMatrices(jds) as seen:
            pc = jpf.PCAIR(_jax_options(kw))
            pc.setup_device(make(), dtype=jnp.float64)
        cache[name] = (pc, seen)
    return cache[name]


@pytest.mark.parametrize("name", list(SETUPS))
def test_setup_device_matches_reference(name, reference_setups,
                                        host_kernels, request):
    make, kw, seed, max_it, tie_free = SETUPS[name]
    pj, seen_j = _reference(name, reference_setups)
    A = make()
    with LevelMatrices(tds) as seen_t:
        pt = tpf.PCAIR(tpf.AIROptions().replace(**kw), dtype=torch.float64,
                       device="cpu").setup_device(A)
    hj, ht = pj.hierarchy, pt.hierarchy
    assert isinstance(ht, tds.DeviceSetupHierarchy)
    assert pt.upload() is ht.solve_form
    notes, diverged, _, _ = compare_setups(
        _jax_levels(hj), setup_levels(ht), seen_j, seen_t, pt.options,
        VALUES_RTOL, INVERSE_RTOL)
    for key, val in notes:
        request.node.user_properties.append((key, val))
    assert not (tie_free and diverged), notes
    if not diverged:
        assert ht.n_levels == hj.n_levels
        n_c = ht.coarse_A.shape[0]
        inverses_close(
            inverse_view(hj.coarse_inv, hj.coarse_inv.apply(
                jnp.asarray(probe_vector(n_c)))),
            port_inverse_view(ht.coarse_inv, n_c, ht.coarse_A.data),
            VALUES_RTOL, INVERSE_RTOL, "coarse inverse")
        r = np.random.default_rng(0).standard_normal(A.shape[0])
        aj = np.asarray(pj.apply(jnp.asarray(r)))
        at = pt.apply(r).numpy()
        assert np.abs(at - aj).max() <= INVERSE_RTOL * np.abs(aj).max()
    b = np.random.default_rng(seed).standard_normal(A.shape[0])
    rj = pj.solve(jnp.asarray(b), rtol=1e-8, max_it=max_it)
    rt = pt.solve(b, rtol=1e-8, max_it=max_it)
    ph = jpf.PCAIR(_jax_options(kw))
    ph.setup(A)
    rh = ph.solve(jnp.asarray(b), rtol=1e-8, max_it=max_it)
    assert rt.converged and rt.iterations <= rh.iterations + 3, (
        rt.iterations, rh.iterations)
    if not diverged:
        assert rt.iterations == rj.iterations
    request.node.user_properties.append(
        ("gmres its port/reference device/reference host",
         f"{rt.iterations}/{rj.iterations}/{rh.iterations}"))


# ~~~~~~~~~~~~~~~~~~~~~~~~ envelope and edges ~~~~~~~~~~~~~~~~~~~~~~~~


@pytest.mark.parametrize("kw", [
    dict(one_point_classical_prolong=False),
    dict(symmetric=True),
    dict(inverse_type="SAI"),
    dict(smooth_order="fcf"),
    dict(cf_splitting_type="AGG"),
])
def test_envelope_prints_the_reason_and_sets_up_on_the_host(kw, capsys):
    from pflare_tpu_torch.air.hierarchy import Hierarchy

    jo = jpf.AIROptions().replace(**kw) if "smooth_order" in kw else \
        _jax_options(kw)
    to = tpf.AIROptions().replace(**kw)
    want = jds.device_setup_unsupported_reason(jo)
    assert want is not None
    assert tds.device_setup_unsupported_reason(to) == want
    assert not tds.device_setup_supported(to)
    A = jpf.adv_diff_2d(16)
    pc = tpf.PCAIR(to, dtype=torch.float64, device="cpu").setup_device(A)
    assert want in capsys.readouterr().err
    assert isinstance(pc.hierarchy, Hierarchy)
    assert pc.solve(np.ones(A.shape[0]), rtol=1e-6, max_it=40).converged


def test_envelope_reasons_match_on_the_supported_sets():
    for kw in ({}, dict(z_type="LAIR"), dict(cf_splitting_type="CR"),
               dict(inverse_type="NEWTON", matrix_free_polys=True)):
        assert tds.device_setup_unsupported_reason(
            tpf.AIROptions().replace(**kw)) is None
        assert jds.device_setup_unsupported_reason(_jax_options(kw)) is None


def test_tiny_matrix_single_level():
    """tests/test_device_setup.py:388-401."""
    A = sp.csr_matrix(np.diag(np.arange(1.0, 7.0)) + 0.1 * np.eye(6, k=1))
    A.sort_indices()
    pc = tpf.PCAIR(dtype=torch.float64, device="cpu").setup_device(A)
    assert pc.n_levels == 1
    x, _ = pc.solve_device(np.ones(6), max_it=10)
    assert np.linalg.norm(A @ x.numpy() - 1.0) < 1e-8
    pj = jpf.PCAIR(jpf.AIROptions())
    pj.setup_device(A, dtype=jnp.float64)
    xj, _ = pj.solve_device(jnp.ones(6), max_it=10)
    assert np.abs(x.numpy() - np.asarray(xj)).max() < 1e-12


def test_auto_truncation_matches_reference():
    """tests/test_device_setup.py:191-206: the probe stops the hierarchy
    at the level the reference stops it."""
    kw = dict(max_levels=10, auto_truncate_start_level=3,
              auto_truncate_tol=0.5, coarsest_inverse_type="NEWTON",
              coarsest_poly_order=12, coarsest_matrix_free_polys=True)
    A = jpf.adv_diff_2d(32)
    pj = jpf.PCAIR(_jax_options(kw))
    pj.setup_device(A, dtype=jnp.float64)
    pt = tpf.PCAIR(tpf.AIROptions().replace(**kw), dtype=torch.float64,
                   device="cpu").setup_device(A)
    assert pt.n_levels < 10
    assert pt.hierarchy.auto_truncated == (pj.n_levels < 10)
    assert pt.n_levels == pj.n_levels
    b = np.random.default_rng(5).standard_normal(A.shape[0])
    assert pt.solve(b, rtol=1e-7, max_it=20).converged


def test_dell_input_matches_scipy_input():
    A = jpf.adv_diff_2d(24)
    o = tpf.AIROptions(max_levels=4)
    p1 = tpf.PCAIR(o, dtype=torch.float64, device="cpu").setup_device(A)
    D = dell_from_numpy(*(np.asarray(x) for x in (
        jdl(A).data, jdl(A).cols)), A.shape[1], device="cpu")
    p2 = tpf.PCAIR(o, dtype=torch.float64, device="cpu").setup_device(D)
    s1, s2 = p1.upload().to_scipy(), p2.upload().to_scipy()
    assert s1.keys() == s2.keys()
    for k in s1:
        close(s2[k], s1[k], 0.0, k)
    with pytest.raises(ValueError, match="cannot reorder"):
        tpf.PCAIR(o.replace(reorder="rcm"), device="cpu").setup_device(D)


def test_reorder_rcm_takes_the_callers_order():
    A = jpf.adv_diff_2d(16)
    perm = np.random.default_rng(3).permutation(A.shape[0])
    As = sp.csr_matrix(A[perm][:, perm])
    b = np.random.default_rng(4).standard_normal(A.shape[0])
    o = tpf.AIROptions(max_levels=4)
    pr = tpf.PCAIR(o.replace(reorder="rcm"), dtype=torch.float64,
                   device="cpu").setup_device(As)
    res = pr.solve(b, rtol=1e-8, max_it=30)
    assert res.converged
    true = np.linalg.norm(As @ res.x.numpy() - b) / np.linalg.norm(b)
    assert true < 1e-7
    pj = jpf.PCAIR(jpf.AIROptions(max_levels=4, reorder="rcm"))
    pj.setup_device(As, dtype=jnp.float64)
    rj = pj.solve(jnp.asarray(b), rtol=1e-8, max_it=30)
    assert res.iterations <= rj.iterations + 3


# ~~~~~~~~~~~~~~~~~~ reference faults after setup_device ~~~~~~~~~~~~~~~~~~


def test_resetup_same_after_setup_device_raises():
    """Reference fault (ROADMAP queue 3): with reuse_sparsity,
    setup(A2, "same") after setup_device reads host patterns a
    device-built level lacks (pflare_tpu/air/hierarchy.py:292-313) and
    fails with AttributeError; the port raises a ValueError that says
    so."""
    A = jpf.adv_diff_2d(16)
    pj = jpf.PCAIR(jpf.AIROptions(reuse_sparsity=True, max_levels=3))
    pj.setup_device(A, dtype=jnp.float64)
    with pytest.raises(AttributeError):
        pj.setup(A, structure="same")
    pt = tpf.PCAIR(tpf.AIROptions(reuse_sparsity=True, max_levels=3),
                   dtype=torch.float64, device="cpu").setup_device(A)
    with pytest.raises(ValueError, match="device-built"):
        pt.setup(A, structure="same")
    with pytest.raises(ValueError, match="device-built"):
        pt.build_device_resetup()


def test_stats_after_setup_device_raises():
    """Reference fault (ROADMAP queue 3): stats() reads the host matrix of
    each level (pflare_tpu/air/stats.py:38-41), which a device-built
    level lacks; the port raises a ValueError that says so."""
    A = jpf.adv_diff_2d(16)
    pj = jpf.PCAIR(jpf.AIROptions(max_levels=3))
    pj.setup_device(A, dtype=jnp.float64)
    with pytest.raises(AttributeError):
        pj.stats()
    pt = tpf.PCAIR(tpf.AIROptions(max_levels=3), dtype=torch.float64,
                   device="cpu").setup_device(A)
    with pytest.raises(ValueError, match="device-built"):
        pt.stats()


def test_device_form_stays_where_it_was_built():
    A = jpf.adv_diff_2d(16)
    pt = tpf.PCAIR(dtype=torch.float64, device="cpu").setup_device(A)
    with pytest.raises(ValueError, match="lives on cpu"):
        pt.hierarchy.to("cpu", torch.float32)
    assert pt.on("cpu").upload() is pt.upload()
