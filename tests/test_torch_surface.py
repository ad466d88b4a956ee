"""The public surface the port shares with the reference: the sparse
containers' helpers (ELL/TELL flat values, transpose product, diagonal,
``spmv``), ``duplicate_plus_diag``, ``scipy_matmat``,
``SparsityPattern.from_scipy``/``keys``, ``DIA.astype``, the native
``spgemm_native``/``csr_to_ell_native`` and the timers' ``timer_time``
and call counts, each held to the JAX package's on seeded inputs."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pflare_tpu as jpf
import pflare_tpu_torch as tpf
from pflare_tpu import native as jnative
from pflare_tpu.sparse import DIA as JDIA
from pflare_tpu.sparse import TELL as JTELL
from pflare_tpu.sparse import ops as jops
from pflare_tpu.sparse import spgemm as jspgemm
from pflare_tpu.utils import timers as jtimers
from pflare_tpu_torch import native as tnative
from pflare_tpu_torch.sparse import DIA, ELL, TELL, SparsityPattern, spmv
from pflare_tpu_torch.sparse import ops as tops
from pflare_tpu_torch.sparse import spgemm as tspgemm
from pflare_tpu_torch.utils import timers as ttimers
from torch_reference import NUMPY, host_kernels  # noqa: F401

torch.set_num_threads(1)


def _random_300(seed=4):
    """300 rows, 240 columns, about 3% dense, one empty row and one empty
    column."""
    A = sp.random(300, 240, density=0.03, random_state=seed, format="csr")
    A = sp.lil_matrix(A)
    A[17, :] = 0
    A[:, 31] = 0
    A = sp.csr_matrix(A)
    A.eliminate_zeros()
    A.sort_indices()
    return A


CASES = {"adv_diff_2d(16)": lambda: tpf.adv_diff_2d(16),
         "random 300 x 240": _random_300}


def _close(got, want, rtol=1e-14):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("case", list(CASES))
def test_ell_helpers_match_reference(case):
    """``spmv``, ``matvec_t``, ``diagonal``, the ``from_flat`` /
    ``flat_values`` round trip and ``with_data`` of ELL, against the
    reference's, within 1e-14 of the largest value in f64."""
    A = CASES[case]()
    rng = np.random.default_rng(1)
    x, xt = rng.standard_normal(A.shape[1]), rng.standard_normal(A.shape[0])
    J, T = jpf.ELL.from_scipy(A), ELL.from_scipy(A)
    _close(spmv(T, torch.as_tensor(x)), jpf.sparse.spmv(J, jnp.asarray(x)))
    _close(T.matvec_t(torch.as_tensor(xt)), J.matvec_t(jnp.asarray(xt)))
    _close(T.diagonal(), J.diagonal())
    flat = T.flat_values()
    assert np.array_equal(flat.numpy(), np.asarray(J.flat_values()))
    assert np.array_equal(flat.numpy(), A.data)
    back = ELL.from_flat(T.pattern, 2.0 * flat)
    want = jpf.ELL.from_flat(J.pattern, 2.0 * J.flat_values())
    assert np.array_equal(back.data.numpy(), np.asarray(want.data))
    assert np.array_equal(back.cols.numpy(), np.asarray(want.cols))
    W = T.with_data(3.0 * T.data)
    assert W.cols is T.cols and W.pattern is T.pattern
    _close(W.matvec(torch.as_tensor(x)), 3.0 * (A @ x))


@pytest.mark.parametrize("case", list(CASES))
def test_tell_helpers_match_reference(case):
    """TELL's ``from_flat``, ``flat_values``, ``with_data``, ``to_ell``
    and ``diagonal`` against the reference's, and a product through
    ``to_ell`` against scipy."""
    A = CASES[case]()
    x = np.random.default_rng(2).standard_normal(A.shape[1])
    J, T = JTELL.from_scipy(A), TELL.from_scipy(A)
    flat = T.flat_values()
    assert np.array_equal(flat.numpy(), np.asarray(J.flat_values()))
    back = TELL.from_flat(T.pattern, flat)
    want = JTELL.from_flat(J.pattern, J.flat_values())
    assert np.array_equal(back.data.numpy(), np.asarray(want.data))
    assert np.array_equal(back.cols.numpy(), np.asarray(want.cols))
    assert np.array_equal(back.data.numpy(), T.data.numpy())
    _close(T.diagonal(), J.diagonal())
    E, JE = T.to_ell(), J.to_ell()
    assert np.array_equal(E.data.numpy(), np.asarray(JE.data))
    assert np.array_equal(E.cols.numpy(), np.asarray(JE.cols))
    _close(spmv(E, torch.as_tensor(x)), A @ x)
    W = T.with_data(-T.data)
    _close(W.matvec(torch.as_tensor(x)), -(A @ x))


@pytest.mark.parametrize("case", list(CASES))
def test_sparse_helpers_match_reference_bitwise(case):
    """``duplicate_plus_diag``, ``scipy_matmat`` and
    ``SparsityPattern.from_scipy``/``keys`` equal the reference's bit for
    bit."""
    A = CASES[case]()
    B = sp.random(A.shape[1], 50, density=0.1, random_state=7, format="csr")
    for got, want in ((tops.duplicate_plus_diag(A),
                       jops.duplicate_plus_diag(A)),
                      (tspgemm.scipy_matmat(A, B),
                       jspgemm.scipy_matmat(A, B))):
        assert got.shape == want.shape
        for attr in ("indptr", "indices", "data"):
            assert np.array_equal(getattr(got, attr), getattr(want, attr))
    D = tops.duplicate_plus_diag(A)
    assert (D - A).nnz == 0
    assert np.all(D.diagonal() == A.diagonal())
    tp, jp = SparsityPattern.from_scipy(A), jpf.SparsityPattern.from_scipy(A)
    assert np.array_equal(tp.keys(), jp.keys())
    assert np.all(np.diff(tp.keys()) > 0)


def test_dia_astype_matches_reference():
    """``DIA.astype`` keeps offsets and shape and rounds the values as
    the reference's does (torch and numpy dtypes alike)."""
    A = tpf.adv_diff_2d(16)
    T = DIA.from_scipy(A)
    J = JDIA.from_scipy(A)
    want = J.astype(np.float32).to_scipy()
    for dtype in (torch.float32, np.float32):
        got = T.astype(dtype)
        assert got.dtype == torch.float32 and got.offsets == T.offsets
        assert (got.to_scipy() != want).nnz == 0
    assert T.astype(torch.float64).data.dtype == torch.float64


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
def test_native_wrappers_match_reference_bitwise(host_kernels, index_dtype):
    """``csr_to_ell_native`` and ``spgemm_native`` give the reference's
    arrays bit for bit (both None when the native kernels are off)."""
    A = _random_300()
    B = sp.random(240, 90, density=0.05, random_state=3, format="csr")
    ip, ind = A.indptr.astype(index_dtype), A.indices.astype(index_dtype)
    K = int(np.diff(A.indptr).max())
    got = tnative.csr_to_ell_native(ip, ind, A.shape[0], K)
    want = jnative.csr_to_ell_native(ip, ind, A.shape[0], K)
    C, JC = tnative.spgemm_native(A, B), jnative.spgemm_native(A, B)
    if host_kernels == NUMPY:
        assert got is None and want is None and C is None and JC is None
        return
    pat = SparsityPattern(A.indptr, A.indices, A.shape)
    for g, w, p in zip(got, want, (pat.ell_cols, pat.slot_of_pos)):
        assert g.dtype == w.dtype and np.array_equal(g, w)
        assert np.array_equal(g, p)
    for attr in ("indptr", "indices", "data"):
        assert np.array_equal(getattr(C, attr), getattr(JC, attr))
    assert abs(C - A @ B).max() <= 1e-15 * abs(A @ B).max()
    with pytest.raises(ValueError):
        tnative.csr_to_ell_native(ip, ind, A.shape[0], K - 1)


def test_timer_time_and_counts_after_setup(host_kernels):
    """After a setup with ``print_stats_timings``, ``timer_time`` reads
    each printed timer, and the port counts its timed regions under the
    names the reference counts them."""
    A = tpf.adv_diff_2d(24)
    opts = dict(print_stats_timings=True, a_lump=True, a_drop=1e-5,
                strong_threshold=0.99)
    ttimers.reset_timers()
    jtimers.reset_timers()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        tpf.PCAIR(tpf.AIROptions(**opts), dtype=torch.float64,
                  device="cpu").setup(A)
        jpf.PCAIR(jpf.AIROptions(**opts)).setup(A)
    timers = ttimers.get_timers()
    assert timers and ttimers.timer_time("no such timer") == 0.0
    for name, seconds in timers.items():
        assert ttimers.timer_time(name) == seconds > 0
        assert f"{ttimers.LABELS[name]} : {seconds:.6f}" in out.getvalue()
    assert ttimers._COUNTS["air_setup"] == 1
    assert set(ttimers._COUNTS) == set(jtimers._COUNTS)
    assert ttimers._COUNTS == jtimers._COUNTS
    ttimers.reset_timers()
    assert ttimers.get_timers() == {} and ttimers._COUNTS == {}


def test_setup_device_spans_by_level():
    """Under ``timers.collect()`` a CPU ``setup_device`` is one
    ``pcair.setup_device`` root holding the reorder and ``air_setup``, with
    one ``setup.level`` span a level, tagged with its index, and the phase
    timers' spans under them; nothing is packed on the CPU, so there is
    no ``dell.pack`` span.  The phase timers still count as before."""
    A = tpf.adv_diff_2d(32)
    pc = tpf.PCAIR(tpf.AIROptions(), dtype=torch.float64, device="cpu")
    ttimers.reset_timers()
    with ttimers.collect() as spans:
        pc.setup_device(A)
    names = [s[0] for s in spans]
    assert [s[0] for s in spans if s[4] == -1] == ["pcair.setup_device"]
    assert {s[5] for s in spans} == {0}
    setup = names.index("air_setup")
    assert spans[names.index("pcair.reorder")][4] == spans[setup][4] == 0
    levels = [i for i, name in enumerate(names) if name == "setup.level"]
    assert [spans[i][1] for i in levels] == list(range(pc.n_levels))
    assert all(spans[i][4] == setup for i in levels)
    phases = [s for s in spans if s[0] in ttimers.LABELS
              and s[0] != "air_setup"]
    assert phases and all(spans[s[4]][0] == "setup.level" for s in phases)
    assert "dell.pack" not in names
    assert {name: v[0] for name, v in ttimers.summary(spans).items()
            if name in ttimers.LABELS} == ttimers._COUNTS
    ttimers.reset_timers()
